"""ViPFormer in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The second package of the repository, beside the JAX/Pallas one
(`vipformer_tpu`), which stays the numerical reference. Module paths and
class names mirror `vipformer_tpu`, so each port module has an obvious
counterpart; state-dict keys follow the flax parameter paths (see
`convert.py`).

This package imports torch, numpy and the standard library only: never
jax, flax or optax. It shares `vipformer_tpu.config` (argparse and
dataclasses only).
"""

__version__ = "0.1.0"
