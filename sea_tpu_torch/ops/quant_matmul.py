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
product outside any kernel. The kernel's grid (column tile width, cluster
size, packed rows a block) comes from ``int4_plan``, a pure function of
the shape, the SM count and how many clusters of each size the card
holds at once (read from the card once, ``device_plan``).

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
from typing import NamedTuple

import torch

# Launches of the CUDA kernel through ``int4_matmul`` (a call on the CPU
# does not count). Read and reset by chip_smoke.py.
launches = 0

# Rows per call that take the kernel's math: serving matvecs are M = B <= 8.
KERNEL_MAX_ROWS = 8
# The kernel's geometry (csrc/quant_matmul.cu, where the same constants
# stand): column tiles of 128 or 64 columns a block (kCols), clusters of at
# most 8 blocks splitting a tile's packed rows (kMaxCluster), 8 packed rows
# per MMA k-step (kStepRows), a ring of 5 (128 columns) or 7 (64 columns)
# stages of 128 packed rows (kStages, kStageRows), each with the x rows
# they pair with ([2][8][128 + 4] f32).
COL_TILE_WIDTHS = (128, 64)
MAX_CLUSTER = 8
STEP_ROWS = 8
STAGE_ROWS = 128
STAGES = {128: 5, 64: 7}
X_STAGE_BYTES = 2 * 8 * (STAGE_ROWS + 4) * 4
# Shared memory a block may have on an H100 (227 KB).
MAX_SMEM_BYTES = 232448
# Per CUDA device: (SM count, cluster slots), int4_plan's inputs.
_DEVICE: dict = {}


class Int4Plan(NamedTuple):
    """The kernel's grid: ``cols``-wide column tiles (``tiles`` of them),
    each split over a cluster of ``cluster`` blocks of ``rows`` packed rows
    (the last one the rest)."""
    cols: int
    tiles: int
    cluster: int
    rows: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.cluster

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of a block: the ring of weights and x, the
        scales of the tile's columns and the cluster's f32 partial sums."""
        stage = STAGE_ROWS * self.cols + X_STAGE_BYTES
        return (STAGES[self.cols] * stage + self.cols * 4
                + (8 * self.cols + MAX_CLUSTER) * 4)


@functools.lru_cache(maxsize=None)
def int4_plan(K: int, N: int, sm_count: int, cluster_slots=None) -> Int4Plan:
    """The kernel's grid for x [M, K] @ wp [K/2, N] on ``sm_count`` SMs.

    ``cluster_slots``: ((cols, cluster size), count) pairs, how many
    clusters of that size the card holds at once at one block an SM (the
    kernel's shared memory allows no more), as the kernel's
    ``sea_int4_cluster_slots`` reports; a cluster must fit inside one GPC,
    so that is often fewer than sm_count // size. None takes sm_count //
    size.

    A plan fits in one wave when its blocks fit on the SMs and its
    clusters in their slots. For each tile width, the cluster is the
    largest (at most MAX_CLUSTER, at most one k-step a block) that fits,
    the rows are split evenly in whole k-steps, and the cluster shrinks so
    that no block is empty. Of the widths, the plan that fits with the
    most blocks wins, the wider on a tie; where none fits, the one with
    the fewest blocks."""
    slots = dict(cluster_slots or ())

    def fits(cols, tiles, cluster):
        return (tiles * cluster <= sm_count
                and tiles <= slots.get((cols, cluster), sm_count // cluster))

    steps = math.ceil(K // 2 / STEP_ROWS)
    plans = []
    for cols in COL_TILE_WIDTHS:
        tiles = math.ceil(N / cols)
        cluster = next((c for c in range(min(MAX_CLUSTER, steps), 0, -1)
                        if fits(cols, tiles, c)), 1)
        per = math.ceil(steps / cluster)
        plans.append(Int4Plan(cols, tiles, math.ceil(steps / per),
                              per * STEP_ROWS))
    one_wave = [p for p in plans if fits(p.cols, p.tiles, p.cluster)]
    if one_wave:
        return max(one_wave, key=lambda p: (p.blocks, p.cols))
    return min(plans, key=lambda p: (p.blocks, -p.cols))


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


@functools.cache
def _library():
    """The C entries, built at first use; pointers and the stream are
    c_void_p (ctypes would otherwise pass a Python int as 32 bits)."""
    from sea_tpu_torch.ops._build import load_library
    lib = load_library("quant_matmul")
    lib.sea_int4_matvec.restype = ctypes.c_int
    lib.sea_int4_matvec.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.sea_int4_cluster_slots.restype = ctypes.c_int
    lib.sea_int4_cluster_slots.argtypes = [ctypes.c_int] * 2
    return lib


@functools.lru_cache(maxsize=None)
def device_plan(K: int, N: int, dev) -> Int4Plan:
    """The plan the kernel runs at (K, N) on CUDA device ``dev``: int4_plan
    with the device's SM count and cluster slots, read once a device
    (cached: the rollout asks again on every call)."""
    dev = torch.device(dev)
    if dev not in _DEVICE:
        query = _library().sea_int4_cluster_slots
        slots = tuple(((cols, c), query(cols, c))
                      for cols in COL_TILE_WIDTHS
                      for c in range(1, MAX_CLUSTER + 1))
        if min(n for _, n in slots) < 1:
            raise RuntimeError(f"int4 kernel: cluster occupancy query "
                               f"failed on {dev}: {slots}")
        _DEVICE[dev] = (torch.cuda.get_device_properties(
            dev).multi_processor_count, slots)
    return int4_plan(K, N, *_DEVICE[dev])


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
    plan = device_plan(K, N, dev)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    rc = _library().sea_int4_matvec(
        x.data_ptr(), wp.data_ptr(), s.data_ptr(), out.data_ptr(), M, K2, N,
        plan.cols, plan.cluster, plan.rows,
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
