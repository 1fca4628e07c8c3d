"""sea_tpu_torch: the PyTorch/CUDA port of SEA-TPU for NVIDIA Hopper.

The JAX package ``sea_tpu`` is the reference this package is held against.
Module names and parameter layouts follow it one to one (``sea_tpu.ops.
attention`` -> ``sea_tpu_torch.ops.attention``), and weights cross the two
packages unchanged as the npz pytree of ``sea_tpu.utils.checkpoint``.

Ported so far: the f32 scan-engine serving path of ``temporal test``
(see ROADMAP.md for what is still to port). This package imports ``torch``
and never ``jax``; it shares only framework-free ``sea_tpu`` modules
(configs, data, npz checkpoints).
"""

__version__ = "0.1.0"
