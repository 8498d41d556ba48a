"""Model complexity: the parameter count and the FLOPs of one eval forward
(the port's counterpart of vipformer_tpu/evaluation/flops.py; the
reference's fvcore FlopCountAnalysis, eval_zeroshot.py:80-83).

The FLOPs are `torch.utils.flop_counter.FlopCounterMode`'s count of the
forward run on a copy of the model on the meta device, so nothing is
computed and no card is needed, under `ops.cuda.plain_reference_mode`:
every kernel flag takes its plain route, and on meta tensors the kernel
wrappers take their plain twins, whose products the counter sees (it
cannot see inside a kernel launched through ctypes, as XLA's cost model
cannot see inside a Pallas call, the reason for JAX's own reference
mode). The counter counts the matmul family (2 FLOPs a multiply-add of
mm, bmm, addmm, einsum and the like); XLA's cost analysis, which the JAX
package reports, also counts elementwise work (softmax, norms, GELU, the
FPS and kNN distances), so the two numbers differ by definition.
"""

from __future__ import annotations

import copy

import torch
from torch.utils.flop_counter import FlopCounterMode

from vipformer_tpu_torch.ops.cuda import plain_reference_mode


def param_count(model: torch.nn.Module) -> int:
    """Parameters, each once (a shared module counts once); BatchNorm's
    running statistics are buffers and not counted, as JAX's
    utils.param_count leaves out its batch_stats collection."""
    return sum(p.numel() for p in model.parameters())


def forward_flops(model: torch.nn.Module, *sample_args) -> float:
    """FLOPs of the matmul family in one eval forward of `model` on
    `sample_args` (tensors are taken by shape only)."""
    meta = copy.deepcopy(model).to("meta").eval().requires_grad_(False)
    args = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in sample_args]
    counter = FlopCounterMode(display=False)
    with plain_reference_mode(), torch.no_grad(), counter:
        meta(*args)
    return float(counter.get_total_flops())


def complexity_report(model: torch.nn.Module, *sample_args) -> dict:
    return {"params": param_count(model), "flops_per_batch": forward_flops(model, *sample_args)}
