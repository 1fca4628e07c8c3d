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
"""

from __future__ import annotations

from typing import List, Tuple

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
