"""JAX's threefry2x32 PRNG key functions on host Python ints.

The JAX package derives one dropout key per site of the temporal model
from the step key with ``jax.random.fold_in`` and ``jax.random.split``;
the flash kernel and the elementwise dropout then hash positions with the
key's two words. Reproducing the key functions bit for bit gives the port
the JAX package's dropout masks from the same seed. Keys are pairs of
uint32 words held as Python ints, so they stay on the host and no train
step waits on the device for them.

Facts this relies on (``jax_threefry_partitionable=True``, the JAX default
since 0.5):

- ``PRNGKey(s)`` is ``(0, s)`` for 0 <= s < 2**32;
- ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``;
- ``split(k, n)[i]`` is ``fold_in(k, i)``.

tests/test_torch_train.py holds all four functions to ``jax.random``.

``normal`` is ``jax.random.normal`` on tensors, for the variational
encoder's reparameterization noise: threefry2x32 of the key over the
flat index of each element, split into (hi, lo) 32-bit counter words;
the two output words XORed into 32 random bits (the low 8 for bf16);
their top mantissa bits under the exponent of 1.0 give a float in [1, 2),
mapped to a uniform on [nextafter(-1, 0), 1); then sqrt(2) erfinv(u).
tests/test_torch_spatial_train.py holds the bits and the uniform to
``jax.random`` exactly and the normal within a few ulps (XLA's erfinv is
another polynomial than PyTorch's).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

Key = Tuple[int, int]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key: Key, x0: int, x1: int) -> Key:
    """Threefry-2x32 with 20 rounds (Salmon et al., SC'11), as jax.random
    computes it: the key schedule adds k0 ^ k1 ^ 0x1BD11BDA as the third
    word and injects the key after every 4 rounds."""
    ks = (key[0] & _M32, key[1] & _M32,
          (key[0] ^ key[1] ^ 0x1BD11BDA) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**32)."""
    if not 0 <= seed <= _M32:
        raise ValueError(f"seed {seed} outside [0, 2**32)")
    return 0, seed


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``."""
    return threefry2x32(key, 0, data & _M32)


def split(key: Key, n: int = 2) -> List[Key]:
    """``jax.random.split(key, n)``, as a list of n keys."""
    return [fold_in(key, i) for i in range(n)]


def key_to_seed(key: Key) -> Tuple[int, int]:
    """The key's two words read as int32, as the JAX package hands them to
    its dropout hash (``ops/attention._key_to_seed``)."""
    return tuple(w - (1 << 32) if w & 0x80000000 else w for w in key)


def _threefry2x32_tensor(key: Key, x0, x1):
    """threefry2x32 on int64 tensors of uint32 words (a host key)."""
    ks = (key[0] & _M32, key[1] & _M32,
          (key[0] ^ key[1] ^ 0x1BD11BDA) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def random_bits(key: Key, shape, *, device, offset: int = 0) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in
    [0, 2**32): threefry over the partitionable counters (hi, lo) of each
    element's flat index, the two words XORed. ``offset``: the flat index
    of the first element, for a block of rows of a larger array (a rank's
    batch block draws what one device draws for those rows)."""
    idx = torch.arange(offset, offset + math.prod(shape), dtype=torch.int64,
                       device=device)
    b0, b1 = _threefry2x32_tensor(key, idx >> 32, idx & _M32)
    return (b0 ^ b1).reshape(shape)


def uniform_open(key: Key, shape, dtype=torch.float32, *, device,
                 offset: int = 0):
    """The uniform ``jax.random.normal`` draws: U[nextafter(-1, 0), 1) in
    ``dtype`` (float32 or bfloat16), from the random bits' top mantissa
    bits under the exponent of 1.0."""
    bits = random_bits(key, shape, device=device, offset=offset)
    if dtype == torch.float32:
        floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
            torch.float32)
    elif dtype == torch.bfloat16:
        # Seven mantissa bits take 8 random bits (the words' low byte).
        floats = (((bits & 0xFF) >> 1) | 0x3F80).to(torch.int16).view(
            torch.bfloat16)
    else:
        raise ValueError(f"uniform_open: dtype {dtype}, want float32 or "
                         "bfloat16")
    # nextafter(-1, 0) in dtype: -1 plus half the spacing of [1, 2).
    lo = torch.tensor(-1.0 + torch.finfo(dtype).eps / 2, dtype=dtype,
                      device=device)
    floats = floats - 1.0
    return torch.maximum(lo, floats * (1.0 - lo) + lo)


def normal(key: Key, shape, dtype=torch.float32, *, device,
           offset: int = 0) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)`` for float32 or bfloat16:
    sqrt(2) erfinv(u) of ``uniform_open`` (erfinv in f32 for bf16, as XLA
    widens it). ``offset``: see ``random_bits``."""
    u = uniform_open(key, tuple(shape), dtype, device=device, offset=offset)
    z = torch.erfinv(u.float()).to(dtype)
    return z * torch.tensor(math.sqrt(2.0), dtype=dtype, device=device)
