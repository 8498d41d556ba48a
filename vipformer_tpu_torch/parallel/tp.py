"""Megatron's two exchanges over the model group (tensor parallelism; the
JAX package gets the same from GSPMD, parallel/sharding.py:1-10 there).

A column-sharded Dense (q/k/v projections, the MLP's first Dense) holds
its rows of the output features, so the model ranks of one data index
compute disjoint slices of the same product from the same replicated
input: the input's gradient is a partial sum on each rank.
`copy_to_model` sits in front of that input: identity forward, all-reduce
backward. A row-sharded Dense (o_proj, the MLP's second Dense) holds the
matching columns of the input features, so each rank's product is a
partial sum of the output: `reduce_from_model` sits after the product and
before the bias, all-reduce forward, identity backward. Both are
identities at T = 1.

The sums run in f32 (a bf16 tensor is summed in f32 and rounded once), so
their result does not depend on how the backend orders a bf16 sum, and
every member of the group gets the same bits.
"""

from __future__ import annotations

import torch

from vipformer_tpu_torch.parallel.mesh import MODEL_AXIS, all_reduce_, model_axis_size


def sum_over_model(t: torch.Tensor) -> torch.Tensor:
    """A new tensor: t summed over the model group, in f32, in t's dtype."""
    f = t.float().clone() if t.dtype == torch.float32 else t.float()
    return all_reduce_(f, MODEL_AXIS).to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return sum_over_model(g)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return sum_over_model(x)

    @staticmethod
    def backward(ctx, g):
        return g


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """x, whose gradient is summed over the model group (the input of a
    column-sharded product)."""
    return x if model_axis_size() == 1 else _CopyToModel.apply(x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """x summed over the model group (a row-sharded product's partial
    sums), its gradient passed through."""
    return x if model_axis_size() == 1 else _ReduceFromModel.apply(x)
