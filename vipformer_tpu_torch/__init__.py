"""ViPFormer in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The second package of the repository, beside the JAX/Pallas one
(`vipformer_tpu`), which stays the numerical reference. Module paths and
class names mirror `vipformer_tpu`, so each port module has an obvious
counterpart; state-dict keys follow the flax parameter paths (see
`convert.py`).

This package imports torch, numpy and the standard library only: never
jax, flax or optax, and nothing of `vipformer_tpu`, not even its modules
that import no JAX: it keeps its own copies of those it needs (`config.py`,
`train/schedules.py`, `data/`).
"""

__version__ = "0.1.0"
