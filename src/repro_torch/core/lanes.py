"""Batched network states: B lanes of one static net in one ``NetState``.

A batched state is a :class:`repro_torch.core.network.NetState` whose
tensor leaves carry a leading ``[B]`` lane axis (``neurons.v`` ``[B, N]``,
``ring`` ``[B, L, N, C]``, ``key`` ``[B, 2]``, each lane's weights ``[B,
...]``) and whose ``t`` is a tuple of B Python ints, one tick per lane:
lanes may stand at different ticks. ``engine.run_batch`` returns one and
``serve.LaneScheduler`` keeps one; these helpers read and write a lane.
"""
from __future__ import annotations

import torch

from repro_torch.core.network import NetState

__all__ = ["stack_states", "broadcast_state", "lane_state", "set_lane", "n_lanes"]


def _map(fn, tree, *rest):
    """``fn`` over the tensors of a nested NamedTuple/tuple tree (and the
    trees of ``rest`` alike), keeping None where the tree has None."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, tuple):
        items = [_map(fn, x, *(r[i] for r in rest)) for i, x in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    raise TypeError(f"unexpected leaf {type(tree).__name__} in a NetState")


def _tensors(state: NetState) -> NetState:
    return state._replace(t=None)


def n_lanes(states: NetState) -> int:
    return len(states.t)


def stack_states(states) -> NetState:
    """One batched state from B one-lane states (copies)."""
    states = list(states)
    stacked = _map(lambda *xs: torch.stack(xs), *map(_tensors, states))
    return stacked._replace(t=tuple(s.t for s in states))


def broadcast_state(state: NetState, batch: int) -> NetState:
    """``batch`` lanes, each a copy of the one-lane ``state``."""
    lanes = _map(lambda x: x.expand(batch, *x.shape).clone(), _tensors(state))
    return lanes._replace(t=(state.t,) * batch)


def lane_state(states: NetState, lane: int) -> NetState:
    """Lane ``lane`` of a batched state, as a one-lane state of its own
    (copies: later writes into ``states`` leave it as it is)."""
    one = _map(lambda x: x[lane].clone(), _tensors(states))
    return one._replace(t=states.t[lane])


def set_lane(states: NetState, lane: int, state: NetState) -> NetState:
    """Write the one-lane ``state`` into lane ``lane`` of ``states``, in
    place on its tensors; returns ``states`` with the lane's tick."""
    _map(lambda dst, src: dst[lane].copy_(src), _tensors(states), _tensors(state))
    t = list(states.t)
    t[lane] = state.t
    return states._replace(t=tuple(t))
