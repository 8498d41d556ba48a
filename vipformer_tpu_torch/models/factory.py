"""Model factory (counterpart of vipformer_tpu/models/factory.py): the
CrossFormer models (`mp`: pretraining, classification finetune, part and
semantic segmentation) and the generic Perceiver family (`mp=False`:
pretraining and classification finetune; the JAX package has no non-mp
segmentation).

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
    CrossFormerSemSeg,
)
from vipformer_tpu_torch.models.perceiver_models import PerceiverClassifier, PerceiverFeatsModel


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


def _perceiver_common(cfg: Config) -> dict:
    """The Perceiver encoder's settings as JAX factory.py:47-143 passes
    them (the weight-sharing flags keep their module defaults)."""
    return dict(
        num_latent_channels=cfg.num_latent_channels,
        num_cross_attention_heads=cfg.num_ca_heads,
        num_cross_attention_qk_channels=cfg.num_latent_channels,
        num_cross_attention_layers=cfg.num_ca_layers,
        cross_attention_widening_factor=cfg.mlp_widen_factor,
        num_self_attention_heads=cfg.num_sa_heads,
        num_self_attention_layers_per_block=cfg.num_sa_layers_per_block,
        num_self_attention_blocks=cfg.num_sa_blocks,
        self_attention_widening_factor=cfg.mlp_widen_factor,
        max_dpr=cfg.max_dpr,
        atten_drop=cfg.atten_drop,
        mlp_drop=cfg.mlp_drop,
        dtype=compute_dtype(cfg),
    )


def build_pc_model(cfg: Config, device="cuda", seed: int | None = None):
    """Pretraining point branch: CrossFormerPC, or with `mp=False` the
    Perceiver feature model over the per-point adapter."""
    seed = cfg.seed if seed is None else seed
    if not cfg.mp:
        return PerceiverFeatsModel("pointcloud", cfg.num_pc_latents, device=device, seed=seed,
                                   **_perceiver_common(cfg))
    return CrossFormerPC(**_mp_common(cfg), device=device, seed=seed)


def build_img_model(cfg: Config, device="cuda", seed: int | None = None):
    """Pretraining image branch: CrossFormerImg (the point branch's encoder
    widths), or with `mp=False` the Perceiver feature model over the
    Fourier pixel adapter."""
    seed = cfg.seed + 10 if seed is None else seed
    if not cfg.mp:
        return PerceiverFeatsModel("image", cfg.num_img_latents,
                                   image_shape=(cfg.img_height, cfg.img_width, 3),
                                   num_frequency_bands=cfg.num_frequency_bands, device=device,
                                   seed=seed, **_perceiver_common(cfg))
    return CrossFormerImg(img_height=cfg.img_height, img_width=cfg.img_width,
                          patch_size=cfg.patch_size, **_encoder_common(cfg), device=device,
                          seed=seed)


def build_ft_cls(cfg: Config, device="cuda", seed: int | None = None):
    """Classification finetune model: CrossFormerPCFT, or with `mp=False`
    the Perceiver classifier with its output-query decoder."""
    seed = cfg.seed if seed is None else seed
    if not cfg.mp:
        return PerceiverClassifier("pointcloud", cfg.num_pc_latents, num_classes=cfg.num_obj_classes,
                                   num_output_queries=cfg.output_seq_length, device=device,
                                   seed=seed, **_perceiver_common(cfg))
    return CrossFormerPCFT(**_mp_common(cfg), num_obj_classes=cfg.num_obj_classes,
                           device=device, seed=seed)


def build_ft_partseg(cfg: Config, device="cuda", seed: int | None = None) -> CrossFormerPartSeg:
    """Part-segmentation model (JAX factory.py:146-156): taps `layer_idx`,
    (2, 6, 10) when the config gives none. The mp family only: the JAX
    package has no Perceiver part segmentation."""
    if not cfg.mp:
        raise NotImplementedError("part segmentation exists only for the mp family (mp=True)")
    return CrossFormerPartSeg(**_mp_common(cfg), layer_idx=tuple(cfg.layer_idx or (2, 6, 10)),
                              num_part_classes=cfg.num_part_classes, device=device,
                              seed=cfg.seed if seed is None else seed)


def build_ft_semseg(cfg: Config, device="cuda", seed: int | None = None) -> CrossFormerSemSeg:
    """Semantic-segmentation model (JAX factory.py:159-171): `point_channels`
    input channels, taps `layer_idx` ((2, 6, 10) when the config gives
    none), `num_obj_classes` classes; the mp model whatever `mp` says, as
    in JAX."""
    return CrossFormerSemSeg(point_channels=cfg.point_channels, **_mp_common(cfg),
                             layer_idx=tuple(cfg.layer_idx or (2, 6, 10)),
                             num_obj_classes=cfg.num_obj_classes, device=device,
                             seed=cfg.seed if seed is None else seed)
