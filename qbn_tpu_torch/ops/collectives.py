"""The collectives of a data-parallel step over a torch.distributed
process group (parallel/sharded.py), for the layers that compute over the
global batch.

`data_parallel(group)` marks the forward of a sharded step: while it is
active the quantities that qbn_tpu computes over the global batch (batch
norm's batch statistics, the observers' extrema) are reduced over the
group (`data_group`, `global_moments`, `global_extrema`). The metric
states and the gradients are summed with `all_reduce_sum`, the sharded
MC evaluation's outputs joined with `all_gather_rows`.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

_DATA_GROUP = None


@contextlib.contextmanager
def data_parallel(group):
    """Within: a forward sees the rows of one rank of `group`; batch norm
    and the observers reduce over the group (None: no reduction)."""
    global _DATA_GROUP
    saved, _DATA_GROUP = _DATA_GROUP, group
    try:
        yield
    finally:
        _DATA_GROUP = saved


def data_group():
    """The group of the active data-parallel forward, else None."""
    return _DATA_GROUP


class _AllReduceSum(torch.autograd.Function):
    """The sum of a tensor over a group; its gradient is the sum of the
    ranks' gradients (each rank's term reaches every rank's loss)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def global_moments(y: torch.Tensor, dims, group):
    """(mean, biased variance, count) over `dims` of y's rows on every
    rank of `group`: the global sum, then the global sum of squared
    deviations from the global mean, each through an all-reduce that
    autograd differentiates, so that the gradient flows through the
    global statistics as in an SPMD step."""
    n = math.prod(y.shape[d] for d in dims) * dist.get_world_size(group)
    m = _AllReduceSum.apply(torch.sum(y, dim=dims), group) / n
    v = _AllReduceSum.apply(torch.sum(torch.square(y - m), dim=dims),
                            group) / n
    return m, v, n


def global_extrema(mn: torch.Tensor, mx: torch.Tensor, group):
    """(min, max) of scalars over the ranks of `group`, in one MAX
    all-reduce of (-min, max)."""
    t = torch.stack([-mn, mx])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return -t[0], t[1]


def all_reduce_sum(tensors, group):
    """The element-wise sums over `group` of a list of tensors, in one
    all-reduce of their concatenation."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return out


def all_gather_rows(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The tensors of every rank of `group` joined along `dim`, in the
    group's rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)
