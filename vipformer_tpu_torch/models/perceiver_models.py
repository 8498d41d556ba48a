"""The generic Perceiver family's models (counterpart of
vipformer_tpu/models/perceiver_models.py, the reference's non-`--mp`
path): the pretraining feature models of both branches and the
classifier.

Like the CrossFormer models, each takes `device` (the card by default),
`dtype` (the compute dtype; parameters stay f32) and a `seed` for its
random init, and is built in eval mode; `model.train()` switches to the
training forward, whose dropout and DropPath draw from the `generator`
argument.
"""

from __future__ import annotations

import torch
from torch import nn

from vipformer_tpu_torch.models.crossformer import FinetuneHead, _finish
from vipformer_tpu_torch.nn.adapters import ClassificationOutputAdapter, ImageInputAdapter
from vipformer_tpu_torch.nn.perceiver import (
    LatentFeatsHead,
    PerceiverDecoder,
    PerceiverEncoder,
    pool_latents,
)
from vipformer_tpu_torch.nn.pointnet import PointCloudInputAdapter


def _input_adapter(adapter: str, d: int, image_shape, num_frequency_bands: int, dtype):
    """(input_adapter, its token width): "pointcloud" -> the per-point MLP
    3 -> 64 -> D, "image" -> the Fourier pixel adapter."""
    if adapter == "pointcloud":
        return PointCloudInputAdapter(3, d, dtype), d
    if adapter == "image":
        ad = ImageInputAdapter(image_shape, num_frequency_bands)
        return ad, ad.num_input_channels
    raise ValueError(f"unknown adapter {adapter!r}")


class _PerceiverBackbone(nn.Module):
    """Input adapter + PerceiverEncoder, the common body of both models."""

    def __init__(self, adapter: str, num_latents: int, num_latent_channels: int,
                 image_shape, num_frequency_bands: int, dtype, **encoder):
        super().__init__()
        self.dtype = dtype
        self.input_adapter, din = _input_adapter(adapter, num_latent_channels, image_shape,
                                                 num_frequency_bands, dtype)
        self.encoder = PerceiverEncoder(num_latents, num_latent_channels, din, dtype=dtype,
                                        **encoder)

    def latents(self, x, generator=None):
        dt = self.dtype or x.dtype
        return self.encoder(self.input_adapter(x.to(dt)), generator)


class PerceiverFeatsModel(_PerceiverBackbone):
    """Input adapter + PerceiverEncoder + pooled contrastive head (JAX
    perceiver_models.py:31-107): points [B, N, 3] or images [B, H, W, 3]
    -> (projected_feats [B, D], backbone_feats [B, 2D]). The keyword
    arguments are the encoder's (JAX's fields, among them
    `num_cross_attention_v_channels`; no CLI sets that one)."""

    def __init__(self, adapter: str, num_latents: int, num_latent_channels: int,
                 image_shape=(224, 224, 3), num_frequency_bands: int = 64, dtype=None,
                 device="cuda", seed: int = 0, **encoder):
        super().__init__(adapter, num_latents, num_latent_channels, image_shape,
                         num_frequency_bands, dtype, **encoder)
        self.latent_head = LatentFeatsHead(num_latent_channels, dtype)
        _finish(self, device, seed)

    def forward(self, x, generator=None):
        backbone_feats = pool_latents(self.latents(x, generator))
        return self.latent_head(backbone_feats), backbone_feats


class PerceiverClassifier(_PerceiverBackbone):
    """Input adapter + PerceiverEncoder + classifier (JAX
    perceiver_models.py:110-210): x -> (logits [B, classes], backbone_feats
    [B, 2D]). `decoder="query"` is the output-query PerceiverDecoder (two
    SA layers) read by the `output_adapter`; "pooled" runs the pooled
    latents through the BN/ReLU head 2D -> D -> D/2 -> classes
    (`decoder_var`). The encoder's keyword arguments as
    PerceiverFeatsModel's."""

    def __init__(self, adapter: str, num_latents: int, num_latent_channels: int,
                 num_classes: int, decoder: str = "query", num_output_queries: int = 1,
                 num_cross_attention_heads: int = 4, cross_attention_widening_factor: int = 1,
                 num_self_attention_heads: int = 4, self_attention_widening_factor: int = 1,
                 atten_drop: float = 0.1, mlp_drop: float = 0.5, image_shape=(224, 224, 3),
                 num_frequency_bands: int = 64, dtype=None, device="cuda", seed: int = 0,
                 **encoder):
        shared = dict(num_cross_attention_heads=num_cross_attention_heads,
                      cross_attention_widening_factor=cross_attention_widening_factor,
                      num_self_attention_heads=num_self_attention_heads,
                      self_attention_widening_factor=self_attention_widening_factor,
                      atten_drop=atten_drop, mlp_drop=mlp_drop)
        super().__init__(adapter, num_latents, num_latent_channels, image_shape,
                         num_frequency_bands, dtype, **shared, **encoder)
        d = num_latent_channels
        self.decoder_kind = decoder
        if decoder == "pooled":
            self.decoder_var = FinetuneHead(d, num_classes, dtype)
        elif decoder == "query":
            self.output_adapter = ClassificationOutputAdapter(num_classes, num_output_queries, d,
                                                              dtype)
            # two SA layers, as the reference's utils.py:261
            self.decoder = PerceiverDecoder(d, d, num_cross_attention_qk_channels=d,
                                            num_self_attention_layers_per_block=2, dtype=dtype,
                                            **shared)
        else:
            raise ValueError(f"unknown decoder {decoder!r}")
        _finish(self, device, seed)

    def forward(self, x, generator=None):
        x_latent = self.latents(x, generator)
        feats = pool_latents(x_latent)
        if self.decoder_kind == "pooled":
            return self.decoder_var(feats), feats
        query = self.output_adapter.query(x_latent.shape[0])
        return self.output_adapter(self.decoder(query, x_latent, generator)), feats
