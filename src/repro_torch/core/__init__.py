"""SNN simulation core: the paper's contribution (CARLsim on PyTorch/CUDA)."""
from repro_torch.core.conductance import (
    COBAConfig,
    ConductanceState,
    coba_current,
    decay_and_deliver,
    init_conductance_state,
)
from repro_torch.core.engine import Engine, StepOutput, run, run_batch, step
from repro_torch.core.lanes import broadcast_state, lane_state, set_lane, stack_states
from repro_torch.core.network import (
    BucketSpec,
    CompiledNetwork,
    FusedPlan,
    GroupSpec,
    NetParams,
    NetState,
    NetStatic,
    NetworkBuilder,
)
from repro_torch.core.neurons import (
    NeuronModel,
    NeuronParams,
    NeuronState,
    generator,
    izh4,
    izh9,
    lif,
    update_neurons,
)

__all__ = [
    "COBAConfig", "ConductanceState", "coba_current", "decay_and_deliver",
    "init_conductance_state",
    "Engine", "StepOutput", "run", "run_batch", "step",
    "broadcast_state", "lane_state", "set_lane", "stack_states",
    "BucketSpec", "CompiledNetwork", "FusedPlan", "GroupSpec", "NetParams", "NetState",
    "NetStatic", "NetworkBuilder",
    "NeuronModel", "NeuronParams", "NeuronState",
    "generator", "izh4", "izh9", "lif", "update_neurons",
]
