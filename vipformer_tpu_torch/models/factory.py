"""Model factory (counterpart of vipformer_tpu/models/factory.py), `mp`
branch only: the CrossFormer models of the port's slices so far
(pretraining, classification finetune, part segmentation).

The build functions take the port's own `vipformer_tpu_torch.config.Config` and
return an initialised model (random weights from `seed`) on `device` (the
card unless the caller asks for the CPU), in eval mode; `model.train()`
switches it to the training forward.
"""

from __future__ import annotations

import torch

from vipformer_tpu_torch.config import Config
from vipformer_tpu_torch.models.crossformer import (
    CrossFormerImg,
    CrossFormerPartSeg,
    CrossFormerPC,
    CrossFormerPCFT,
)


def compute_dtype(cfg: Config) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.compute_dtype]


def _encoder_common(cfg: Config) -> dict:
    return dict(
        num_latent_channels=cfg.num_latent_channels,
        num_cross_attention_layers=cfg.num_ca_layers,
        num_cross_attention_heads=cfg.num_ca_heads,
        num_self_attention_layers=cfg.num_sa_layers,
        num_self_attention_heads=cfg.num_sa_heads,
        mlp_widen_factor=cfg.mlp_widen_factor,
        max_dpr=cfg.max_dpr,
        atten_drop=cfg.atten_drop,
        mlp_drop=cfg.mlp_drop,
        dtype=compute_dtype(cfg),
    )


def _mp_common(cfg: Config) -> dict:
    return dict(
        num_latents=cfg.num_pc_latents,
        group_size=cfg.group_size,
        patch_compat=cfg.patch_compat,
        **_encoder_common(cfg),
    )


def _require_mp(cfg: Config) -> None:
    if not cfg.mp:
        raise NotImplementedError(
            "the generic Perceiver family (mp=False) is not ported yet "
            "(ROADMAP Queue 1, item 15)"
        )


def build_pc_model(cfg: Config, device="cuda", seed: int | None = None) -> CrossFormerPC:
    """Pretraining point branch."""
    _require_mp(cfg)
    return CrossFormerPC(**_mp_common(cfg), device=device,
                         seed=cfg.seed if seed is None else seed)


def build_img_model(cfg: Config, device="cuda", seed: int | None = None) -> CrossFormerImg:
    """Pretraining image branch (same encoder widths as the point branch)."""
    _require_mp(cfg)
    return CrossFormerImg(img_height=cfg.img_height, img_width=cfg.img_width,
                          patch_size=cfg.patch_size, **_encoder_common(cfg), device=device,
                          seed=cfg.seed + 10 if seed is None else seed)


def build_ft_cls(cfg: Config, device="cuda", seed: int | None = None) -> CrossFormerPCFT:
    """Classification finetune model."""
    _require_mp(cfg)
    return CrossFormerPCFT(**_mp_common(cfg), num_obj_classes=cfg.num_obj_classes,
                           device=device, seed=cfg.seed if seed is None else seed)


def build_ft_partseg(cfg: Config, device="cuda", seed: int | None = None) -> CrossFormerPartSeg:
    """Part-segmentation model (JAX factory.py:146-156): taps `layer_idx`,
    (2, 6, 10) when the config gives none."""
    _require_mp(cfg)
    return CrossFormerPartSeg(**_mp_common(cfg), layer_idx=tuple(cfg.layer_idx or (2, 6, 10)),
                              num_part_classes=cfg.num_part_classes, device=device,
                              seed=cfg.seed if seed is None else seed)
