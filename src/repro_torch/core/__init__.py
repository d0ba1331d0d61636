"""SNN simulation core: the paper's contribution (CARLsim on PyTorch/CUDA)."""
from repro_torch.core.engine import Engine, StepOutput, run, step
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
    "Engine", "StepOutput", "run", "step",
    "BucketSpec", "CompiledNetwork", "FusedPlan", "GroupSpec", "NetParams", "NetState",
    "NetStatic", "NetworkBuilder",
    "NeuronModel", "NeuronParams", "NeuronState",
    "generator", "izh4", "izh9", "lif", "update_neurons",
]
