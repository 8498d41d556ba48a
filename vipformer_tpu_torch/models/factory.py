"""Model factory (counterpart of vipformer_tpu/models/factory.py), `mp`
branch only: the CrossFormer models of the port's first slice.

Builders take the shared `vipformer_tpu.config.Config` and return an
initialised model (random weights from `seed`) on `device`, in eval mode.
"""

from __future__ import annotations

import torch

from vipformer_tpu.config import Config
from vipformer_tpu_torch.models.crossformer import CrossFormerPC, CrossFormerPCFT


def compute_dtype(cfg: Config) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.compute_dtype]


def _mp_common(cfg: Config) -> dict:
    return dict(
        num_latents=cfg.num_pc_latents,
        num_latent_channels=cfg.num_latent_channels,
        group_size=cfg.group_size,
        patch_compat=cfg.patch_compat,
        num_cross_attention_layers=cfg.num_ca_layers,
        num_cross_attention_heads=cfg.num_ca_heads,
        num_self_attention_layers=cfg.num_sa_layers,
        num_self_attention_heads=cfg.num_sa_heads,
        mlp_widen_factor=cfg.mlp_widen_factor,
        dtype=compute_dtype(cfg),
    )


def _require_mp(cfg: Config) -> None:
    if not cfg.mp:
        raise NotImplementedError(
            "the generic Perceiver family (mp=False) is not ported yet "
            "(ROADMAP Queue 1, item 15)"
        )


def build_pc_model(cfg: Config, device="cpu", seed: int | None = None) -> CrossFormerPC:
    """Pretraining point branch."""
    _require_mp(cfg)
    return CrossFormerPC(**_mp_common(cfg), device=device,
                         seed=cfg.seed if seed is None else seed)


def build_ft_cls(cfg: Config, device="cpu", seed: int | None = None) -> CrossFormerPCFT:
    """Classification finetune model."""
    _require_mp(cfg)
    return CrossFormerPCFT(**_mp_common(cfg), num_obj_classes=cfg.num_obj_classes,
                           device=device, seed=cfg.seed if seed is None else seed)
