"""int4 weight-only matmul for serving: packed nibbles, per-column scale.

Counterpart of ``sea_tpu/ops/quant_matmul.py``. Storage is the JAX
package's: two signed int4 values per uint8, packed along the INPUT dim —
byte ``[k, n]`` holds ``w[k, n]`` in its low nibble and ``w[k + K/2, n]``
in its high nibble — and an f32 scale per output column.

``int4_matmul`` routes a call as the JAX package's kernel path computes
it wherever the kernel's math applies (M <= 8 rows, K even): ``y =
(bf16(x) @ unpack(wp)) * s`` with f32 accumulation. On a CUDA tensor that
is the hand-written kernel ``sea_tpu_torch/csrc/quant_matmul.cu``
(replacing the Pallas TPU kernel ``_mv_kernel``); on the CPU its plain
version ``int4_matvec_ref``. Larger calls take the two-plane dequantized
product of the JAX package's fallback, with x not rounded: a plain large
product outside any kernel.

The TPU kernel's gates (backend, ``_KERNEL_MIN_ELEMS``, ``(K/2) % 8``,
``N % 128``, the VMEM budget of ``_pick_block_n``) and its AND/XOR +8
nibble trick with a rank-1 correction are Mosaic workarounds and are not
carried over; the math they preserve is: an exact signed nibble times
bf16-rounded x, accumulated in f32, scaled once.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

# Launches of the CUDA kernel through ``int4_matmul`` (a call on the CPU
# does not count). Read and reset by chip_smoke.py.
launches = 0

# Rows per call that take the kernel's math: serving matvecs are M = B <= 8.
KERNEL_MAX_ROWS = 8
# The kernel's grid (csrc/quant_matmul.cu): a block's strip of columns
# (32 lanes x 16 bytes; kStrip there), the most packed rows a split-K block
# takes (its staged x chunk; kMaxChunk there), and the fewest this plan
# gives it (4 rows for each of its 8 warps).
COLS_PER_BLOCK = 512
MAX_ROWS_PER_SPLIT = 256
MIN_ROWS_PER_SPLIT = 32
_SM_COUNT: dict = {}


def pack_int4(q):
    """int8 [K, N] with values in [-8, 7] -> packed uint8 [K//2, N]."""
    K = q.shape[0]
    if K % 2:
        raise ValueError(f"input dim must be even to pack nibbles, got {K}")
    lo = (q[: K // 2] & 0xF).to(torch.uint8)
    hi = (q[K // 2:] & 0xF).to(torch.uint8)
    return lo | (hi << 4)


def unpack_planes(wp, dtype=torch.bfloat16):
    """packed uint8 [K//2, N] -> (lo, hi) signed nibble planes [K//2, N]
    in ``dtype``; lo pairs with x[:, :K/2], hi with x[:, K/2:]."""
    w8 = wp.view(torch.int8).to(torch.int32)
    lo = ((w8 & 0xF) ^ 8) - 8
    hi = w8 >> 4  # arithmetic shift: the sign of the high nibble
    return lo.to(dtype), hi.to(dtype)


def unpack_int4(wp, dtype=torch.bfloat16):
    """packed uint8 [K//2, N] -> the integer weight [K, N] in ``dtype``."""
    return torch.cat(unpack_planes(wp, dtype), dim=0)


def int4_matvec_ref(x, wp, s):
    """Plain version of the kernel: ``(bf16(x) @ unpack(wp)) * s`` in f32.
    x: [M, K]; wp: uint8 [K//2, N]; s: f32 [N]. Returns f32 [M, N]."""
    xb = x.to(torch.bfloat16).float()
    return (xb @ unpack_int4(wp, torch.float32)) * s.float()


def split_plan(K: int, N: int, sm_count: int):
    """(splits, packed rows per split) of the kernel's split-K grid: about
    two blocks per SM over (column strips x splits), each split a multiple
    of 8 rows (one per warp), at least MIN_ROWS_PER_SPLIT and at most
    MAX_ROWS_PER_SPLIT rows, so the block's staged x chunk stays small."""
    K2 = K // 2
    strips = math.ceil(N / COLS_PER_BLOCK)
    want = max(1, math.ceil(2 * sm_count / strips))
    splits = max(1, min(want, math.ceil(K2 / MIN_ROWS_PER_SPLIT)),
                 math.ceil(K2 / MAX_ROWS_PER_SPLIT))
    chunk = 8 * math.ceil(math.ceil(K2 / splits) / 8)
    return math.ceil(K2 / chunk), chunk


@functools.cache
def _library():
    """The C entry, built at first use; pointers and the stream are
    c_void_p (ctypes would otherwise pass a Python int as 32 bits)."""
    from sea_tpu_torch.ops._build import load_library
    fn = load_library("quant_matmul").sea_int4_matvec
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    return fn


def int4_matvec(x, wp, s):
    """The kernel: x f32 [M, K] (M <= 8, K even), wp uint8 [K//2, N]
    starting on a 16-byte boundary, s f32 [N], all contiguous on the
    current CUDA device. Returns f32 [M, N]."""
    M, K = x.shape
    K2, N = wp.shape
    if not 1 <= M <= KERNEL_MAX_ROWS or K != 2 * K2 or s.shape != (N,):
        raise ValueError(f"int4_matvec: x {tuple(x.shape)}, wp "
                         f"{tuple(wp.shape)}, s {tuple(s.shape)}")
    if x.dtype != torch.float32 or wp.dtype != torch.uint8 \
            or s.dtype != torch.float32:
        raise ValueError(f"int4_matvec takes f32 x, uint8 wp, f32 s; got "
                         f"{x.dtype}, {wp.dtype}, {s.dtype}")
    dev = wp.device
    for name, t in (("x", x), ("wp", wp), ("s", s)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"int4_matvec: {name} must be contiguous on "
                             f"{dev}")
    if wp.data_ptr() % 16:
        # The kernel reads wp's rows as 16-byte vectors.
        raise ValueError("int4_matvec: wp must start on a 16-byte boundary")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"weights on {dev}, but the current CUDA device is "
                         f"{torch.cuda.current_device()}")
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    splits, chunk = split_plan(K, N, _SM_COUNT[dev])
    part = torch.empty((splits, M, N), dtype=torch.float32, device=dev)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    rc = _library()(x.data_ptr(), wp.data_ptr(), s.data_ptr(),
                    part.data_ptr(), out.data_ptr(), M, K2, N, splits, chunk,
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int4 matvec kernel launch failed: CUDA error "
                           f"{rc}")
    global launches
    launches += 1
    return out


def int4_matmul(x, wp, s):
    """y = x @ dequant(wp, s) along x's last dim, f32 [..., N].

    x: [..., K] float; wp: packed uint8 [K//2, N]; s: f32 [N]. Calls of at
    most KERNEL_MAX_ROWS rows take the kernel's math (the CUDA kernel on a
    CUDA tensor, its plain version on the CPU); others the two-plane
    dequantized product with f32 accumulation."""
    *lead, K = x.shape
    N = wp.shape[1]
    M = math.prod(lead)
    x2 = x.reshape(M, K)
    if 1 <= M <= KERNEL_MAX_ROWS and K % 2 == 0:
        if wp.device.type == "cpu":
            y = int4_matvec_ref(x2, wp, s)
        elif wp.device.type == "cuda":
            y = int4_matvec(x2.float().contiguous(), wp, s)
        else:
            raise ValueError(f"int4_matmul runs on CPU or CUDA tensors, not "
                             f"{wp.device}")
    else:
        lo, hi = unpack_planes(wp, torch.float32)
        K2 = K // 2
        xf = x2.float()
        y = (xf[:, :K2] @ lo + xf[:, K2:] @ hi) * s
    return y.reshape(*lead, N)
