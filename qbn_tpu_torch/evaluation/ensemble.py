"""SGHMC posterior ensembles as stacked state trees (port of
qbn_tpu/evaluation/ensemble.py).

An ensemble's state is ONE tree whose leaves carry a leading member axis,
as qbn_tpu's `stack_variables` makes it: each member keeps its own weights
and its own qparams (scales and zero points differ from member to member).
The int8 conv kernel takes scalar qparams, so a member is one launch
group: `evaluation.mc.mc_predict(ensemble=True)` runs one forward per
member on that member's tree (`member`), 20 conv launches each on the
ResNet-18, and stacks the outputs on a leading axis, where qbn_tpu vmaps
one forward over the member axis.
"""

from __future__ import annotations

from typing import List

import torch

from qbn_tpu_torch.convert import from_jax_state
from qbn_tpu_torch.training.checkpoint import list_snapshots, read_checkpoint


def stack_variables(trees: List):
    """Stack N state trees of one structure along a new leading member
    axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_variables([t[k] for t in trees]) for k in first}
    return torch.stack(list(trees))


def member(state, m: int):
    """Member m's tree of a stacked ensemble state."""
    if isinstance(state, dict):
        return {k: member(v, m) for k, v in state.items()}
    return state[m]


def members(state) -> int:
    """The number of members of a stacked ensemble state."""
    while isinstance(state, dict):
        state = next(iter(state.values()))
    return state.shape[0]


def load_ensemble(save_dir: str, samples: int, special_info: str = ""):
    """The last `samples` epoch-stamped snapshots of save_dir, stacked into
    one state tree of CPU tensors (qbn_tpu's tail-N of the natural sort)."""
    paths = list_snapshots(save_dir, special_info)
    if len(paths) < samples:
        raise FileNotFoundError(
            f"need {samples} snapshots matching 'weights_{special_info}N' "
            f"in {save_dir}, found {len(paths)}")
    return stack_variables([from_jax_state(read_checkpoint(p))
                            for p in paths[-samples:]])
