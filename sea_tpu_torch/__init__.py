"""sea_tpu_torch: the PyTorch/CUDA port of SEA-TPU for NVIDIA Hopper.

The JAX package ``sea_tpu`` is the reference this package is held against.
Module names and parameter layouts follow it one to one (``sea_tpu.ops.
attention`` -> ``sea_tpu_torch.ops.attention``), and weights and optimizer
state cross the two packages unchanged as the npz pytree of
``utils/checkpoint.py``.

Ported so far: ``temporal test`` on the scan and prefix engines at f32
and reduced precision, ``temporal generate``, and single-device
``temporal train`` at f32 and bf16 (see ROADMAP.md for what is still to
port). This package imports ``torch`` and never ``jax``, nor any module
of ``sea_tpu``: it keeps its own copies of the framework-free modules it
needs (configs, data, npz checkpoints, tracking).
"""

__version__ = "0.2.0"
