"""Sums over a process group, for the losses and the training step.

A leaf module: it imports ``torch.distributed`` and nothing of the port,
so the losses and metrics can take their batch sums through it. Every
function takes its group explicitly, and ``None`` means one process: the
plain ``x.sum()`` / ``x.mean()`` with no collective, so a caller that
passes no group (an evaluation, a test, rank 0 alone) never waits on the
other ranks.

Data parallelism computes the GLOBAL batch's loss and gradient, as JAX's
sharded step does: each loss takes its batch sums with
:func:`batch_sum` / :func:`batch_mean` over the data group, which
all-reduce in the forward and are the identity in the backward, so each
rank back-propagates its own part of the global loss and summing the
ranks' parameter gradients gives the global gradient
(``parallel.mesh.all_reduce_grads``). A mean of per-rank ratios would be
another number.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced in place over ``group`` (a no-op without one)."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """The sum over ``group`` in the forward; the identity in the backward.

    Every rank goes on from the same reduced value, so the gradient of the
    global loss with respect to one rank's addend is the cotangent itself:
    summing the ranks' parameter gradients afterwards gives the gradient
    of the global loss."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group`` (identity backward)."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def batch_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x.sum()`` over the global batch: this process's tensor summed
    over ``group``, the data-parallel ranks (None: this process alone)."""
    return reduce_sum(x.sum(), group)


def batch_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x.mean()`` over the global batch (every rank of ``group`` holds
    the same number of examples)."""
    if group is None:
        return x.mean()
    return batch_sum(x, group) / (x.numel() * dist.get_world_size(group))
