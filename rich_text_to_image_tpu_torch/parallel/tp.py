"""Tensor parallelism: column shards, each layer's output gathered, and
attention on each rank's own heads.

A sharded ``nn.Linear`` or ``nn.Conv2d`` keeps its rank's contiguous block of
output rows (and of the bias); a forward hook all-gathers its output over the
tp group along the channel dimension right after the layer, so that
GroupNorm, the resnets and the feed-forward see whole tensors. The
exception is an attention block's ``to_q``, ``to_k`` and ``to_v``
(``parallel/mesh.heads_local``): they keep their output local (``gather=False``
below), so that the attention kernels run on this rank's heads alone and
the block gathers once, its output before ``to_out`` (:func:`gather_channels`).
That is what the JAX package's ``custom_partitioning`` rules allow:
batch, heads and query rows pass through a kernel, keys and values stay
whole, and the capture kernel, which averages over the heads, sees every head
(``models/unet.Attention``).

Gradients. Every tp rank computes the same loss from the gathered output, so
the gradient that reaches a gather is the whole one on every rank, and the
gather's backward hands its layer this rank's slice of it (a gather whose
backward sums over the ranks, as ``torch.distributed.nn.functional.all_gather``
does, would scale each shard's gradient by tp). The layer's input gradient
from one shard is only that shard's part of the whole, so a pre-hook routes
the input through an identity whose backward sums over the tp group.
"""

from __future__ import annotations

import torch
from torch import nn

from .mesh import all_gather_cat, all_reduce_sum


class _GatherChannels(torch.autograd.Function):
    """Forward: the ranks' shards concatenated along ``dim``; backward: this
    rank's slice of the incoming gradient."""

    @staticmethod
    def forward(ctx, x, dim, group, rank):
        ctx.dim, ctx.rank, ctx.width = dim, rank, x.shape[dim]
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.rank * ctx.width, ctx.width),
                None, None, None)


def gather_channels(x: torch.Tensor, dim: int, group, rank: int):
    """The tp ranks' blocks of ``x`` concatenated along ``dim`` in rank
    order; under autograd the backward hands this rank its slice of the
    gradient, as a sharded layer's own gather does."""
    return _GatherChannels.apply(x, dim if dim >= 0 else x.dim() + dim,
                                 group, rank)


class _SumGradOverTP(torch.autograd.Function):
    """Identity forward; backward sums the gradient over the tp group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.contiguous(), ctx.group), None


def shard_module(mod: nn.Module, group, rank: int, tp: int,
                 gather: bool = True) -> None:
    """Keep ``mod``'s block ``rank`` of ``tp`` along its output channels
    and gather its output over ``group`` after each forward; with
    ``gather=False`` the output stays this rank's block, and the module
    carries ``tp_local = (rank, tp)`` and ``tp_group`` for the caller
    that gathers it."""
    if getattr(mod, "tp_shard", None) is not None:
        return  # sharded already
    out = mod.weight.shape[0]
    blk = out // tp
    sl = slice(rank * blk, (rank + 1) * blk)
    mod.weight = nn.Parameter(mod.weight.data[sl].clone(),
                              requires_grad=mod.weight.requires_grad)
    if mod.bias is not None:
        mod.bias = nn.Parameter(mod.bias.data[sl].clone(),
                                requires_grad=mod.bias.requires_grad)
    if isinstance(mod, nn.Linear):
        mod.out_features, dim = blk, -1
    else:
        mod.out_channels, dim = blk, 1
    mod.tp_shard = (rank, tp)

    def pre(_mod, args):
        if torch.is_grad_enabled() and args[0].requires_grad:
            return (_SumGradOverTP.apply(args[0], group), *args[1:])
        return None

    def post(_mod, _args, y):
        return gather_channels(y, dim, group, rank)

    mod.register_forward_pre_hook(pre)
    if gather:
        mod.register_forward_hook(post)
    else:
        mod.tp_local, mod.tp_group = (rank, tp), group
