"""Fused AdaLN modulate for the training step: forward and backward.

``fused_adaln_modulate`` is the wrapper of two hand-written CUDA kernels
in ``sea_tpu_torch/csrc/fused_adaln.cu`` (``adaln_fwd_kernel`` and
``adaln_bwd_kernel``) that replace the Pallas TPU kernels ``_fwd_kernel``
and ``_bwd_kernel`` of ``sea_tpu/ops/fused_adaln.py``. On a CUDA tensor it
runs the forward kernel inside a ``torch.autograd.Function`` whose
backward launches the backward kernel, one launch a call each; on a CPU
tensor it computes the plain PyTorch version, ``adaln_modulate_ref``, and
autograd differentiates that.

Function (x [B, T, E] of f32, bf16 or f16; time-constant cond cw, cb
[B, 1, E]; base w, b [E]; f32 row statistics, output in x's dtype):

    out = (x - mean) * rsqrt(var + eps) * (w + cw) + (b + cb)

with ``w + cw`` and ``b + cb`` rounded in the parameter dtype first, as
the TPU kernel does. Backward, per row (a = w + cw, xhat the normalised
row): dx = rstd * (g a - mean(g a) - xhat * mean(g a xhat)); per
trajectory dcw = sum_t g xhat and dcb = sum_t g, and dw = sum_b dcw,
db = sum_b dcb. The backward kernel writes all five in one launch, in a
fixed order of summation, so two calls give the same bits.

The kernels' grid comes from ``adaln_plan``, a pure function of (B, T, E,
the dtype, the alignment) and how many blocks the card runs at once (read
from the card once per shape, ``device_plan``); it never depends on the
data.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

LN_EPS = 1e-5

# Launches of each CUDA kernel (a CPU call does not count). Read and reset
# by chip_smoke.py.
fwd_launches = 0
bwd_launches = 0
# Of those, the launches on bf16 x (the bf16 training recipes).
fwd_launches_bf16 = 0
bwd_launches_bf16 = 0

# The kernels' geometry (csrc/fused_adaln.cu, where the same constants
# stand): blocks of WARPS warps; a row over wpr warps (a power of two up
# to WARPS), each thread holding n of its elements (ELEMS), read as 16-byte
# vectors where E and the pointers allow, else one element at a time; the
# backward's column sums meet inside thread-block clusters of at most
# MAX_CLUSTER blocks, for rows up to CLUSTER_MAX_E; rows up to MAX_E.
WARPS = 8
MAX_CLUSTER = 8
MAX_E = 16384
CLUSTER_MAX_E = 8192
# Elements a thread may hold, by vector width (1: the scalar path). A row
# takes one warp while 32 threads cover it with at most 32 elements each;
# wider rows take more warps at 32, and past WARPS * 32 * 32 columns 64.
ELEMS = {4: (4, 8, 16, 32), 8: (8, 16, 32), 1: (4, 32)}
_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class AdaLNPlan(NamedTuple):
    """vec elements a load (1: scalar); n elements of a row a thread; wpr
    warps a row; nb blocks a trajectory, each taking a contiguous run of
    rows; cs blocks a cluster (the backward's; nb is a multiple)."""
    vec: int
    n: int
    wpr: int
    nb: int
    cs: int


def row_layout(E: int, itemsize: int, aligned: bool):
    """(vec, n, wpr) for a row of E elements of itemsize bytes: 16-byte
    vectors where ``aligned`` (every pointer on 16 bytes) and E is a whole
    number of them, else scalars; one warp a row up to 32 elements a
    thread."""
    vec = 16 // itemsize
    if not aligned or E % vec:
        vec = 1
    for n in ELEMS[vec]:
        if 32 * n >= E:
            return vec, n, 1
    n = 32 if E <= WARPS * 32 * 32 else 64
    wpr = 1 << (math.ceil(E / (32 * n)) - 1).bit_length()
    return vec, n, wpr


def adaln_plan(B: int, T: int, E: int, itemsize: int, aligned: bool,
               slots: int, max_cluster: int = MAX_CLUSTER) -> AdaLNPlan:
    """The grid of either kernel for x [B, T, E]: each trajectory's rows
    over nb blocks, as many as one wave of the card's ``slots`` blocks
    allows (at least one a trajectory) and at most one a row; for the
    backward, nb is cut to a whole number of clusters of cs <= max_cluster
    blocks (1 past CLUSTER_MAX_E columns). A pure function of the shape:
    the same grid for every call, whatever the data."""
    vec, n, wpr = row_layout(E, itemsize, aligned)
    nb = min(T, max(1, slots // B))
    cs = min(max_cluster if E <= CLUSTER_MAX_E else 1, nb)
    return AdaLNPlan(vec, n, wpr, nb // cs * cs, cs)


def adaln_modulate_ref(x, cw, cb, w, b, eps: float = LN_EPS):
    """Plain version (the formula of ``ops.layers.adaln_modulate``)."""
    xf = x.float()
    xhat = F.layer_norm(xf, (xf.shape[-1],), eps=eps)
    return (xhat * (w + cw) + (b + cb)).to(x.dtype)


def adaln_bwd_ref(x, cw, g, w, eps: float = LN_EPS):
    """The backward kernel's outputs: (dx in x's dtype, dcw [B, 1, E],
    dcb [B, 1, E], dw [E], db [E], all four f32), written out as the TPU
    kernel and its VJP compute them."""
    xf, gf = x.float(), g.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xhat = xc * rstd
    dxhat = gf * (w + cw).float()
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    dgw = (gf * xhat).sum(1, keepdim=True)
    dgb = gf.sum(1, keepdim=True)
    return dx.to(x.dtype), dgw, dgb, dgw.sum((0, 1)), dgb.sum((0, 1))


@functools.cache
def _library():
    """The C entries, built at first use. Every pointer and the stream are
    c_void_p: ctypes would otherwise pass a Python int as a 32-bit int."""
    from sea_tpu_torch.ops._build import load_library
    lib = load_library("fused_adaln")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fwd = lib.sea_adaln_fwd
    fwd.restype = i32
    fwd.argtypes = ([ptr] * 6 + [i32] * 3 + [ctypes.c_float] + [i32] * 6
                    + [ptr])
    bwd = lib.sea_adaln_bwd
    bwd.restype = i32
    bwd.argtypes = ([ptr] * 11 + [i32] * 3 + [ctypes.c_float] + [i32] * 7
                    + [ptr])
    lib.sea_adaln_slots.restype = i32
    lib.sea_adaln_slots.argtypes = [i32] * 7
    return fwd, bwd, lib.sea_adaln_slots


@functools.lru_cache(maxsize=None)
def device_plan(backward: bool, B: int, T: int, E: int, dtype, aligned: bool,
                dev) -> AdaLNPlan:
    """adaln_plan on CUDA device ``dev``: its slots are the blocks the card
    runs at once, asked of the card (cudaOccupancyMaxActiveClusters for
    the backward's clusters, or blocks an SM times the SM count). Cached:
    the train step asks on every call."""
    dev = torch.device(dev)
    vec, n, wpr = row_layout(E, dtype.itemsize, aligned)
    cluster = MAX_CLUSTER if backward and E <= CLUSTER_MAX_E else 1
    with torch.cuda.device(dev):
        got = _library()[2](int(backward), _KIND[dtype], vec, n, E, wpr,
                            cluster)
    if got < 1:
        unit = "cluster" if cluster > 1 else "block"
        raise RuntimeError(f"fused AdaLN: no {unit} of the kernel fits "
                           f"{dev} for E={E}, {dtype} (occupancy query: "
                           f"{got})")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    slots = got * cluster if cluster > 1 else got * sms
    return adaln_plan(B, T, E, dtype.itemsize, aligned, slots, cluster)


# Per (device, stream): the backward's arrival counters, one a column
# slice (int32 [MAX_CLUSTER]), zero between calls (the last arrival of each
# count resets it).
_COUNTERS: dict = {}


def _counters(dev, stream):
    key = (dev.index, stream)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(MAX_CLUSTER, dtype=torch.int32,
                                     device=dev)
    return _COUNTERS[key]


def _check(x, cw, w, others):
    """Shapes and dtypes both versions take; ``others`` are the further
    (name, tensor, want shape, want dtype) to hold."""
    if not fused_supported(x, cw, cw):
        raise ValueError(f"fused AdaLN takes x [B,T,E] and cond [B,1,E]; "
                         f"got {tuple(x.shape)} and {tuple(cw.shape)}")
    if w.shape != (x.shape[2],):
        raise ValueError(f"base weight {tuple(w.shape)} for E={x.shape[2]}")
    if x.dtype not in _KIND or w.dtype not in _KIND:
        raise ValueError(f"fused AdaLN takes float x and parameters, not "
                         f"{x.dtype} and {w.dtype}")
    if cw.dtype != w.dtype:
        raise ValueError(f"cond {cw.dtype} and base {w.dtype}: the kernels "
                         "take one parameter dtype")
    for name, t, shape, dtype in others:
        if t.shape != shape or t.dtype != dtype:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, want "
                             f"{dtype} {tuple(shape)}")
    if x.device.type == "cpu":
        return
    for name, t in [("cond", cw), ("weight", w)] + [(o[0], o[1])
                                                    for o in others]:
        if t.device != x.device:
            raise ValueError(f"x on {x.device}, {name} on {t.device}")
    if x.device.type != "cuda":
        raise ValueError(f"fused AdaLN runs on CPU or CUDA tensors, not "
                         f"{x.device}")
    if not 1 <= x.shape[2] <= MAX_E or x.numel() == 0:
        raise ValueError(f"fused AdaLN kernels take 1 <= E <= {MAX_E} and a "
                         f"non-empty x; got {tuple(x.shape)}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"x on {x.device}, but the current CUDA device is "
                         f"{torch.cuda.current_device()}")


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def adaln_fwd(x, cw, cb, w, b, eps: float = LN_EPS):
    """Forward kernel: out [B, T, E] in x's dtype (the plain version for
    CPU tensors)."""
    _check(x, cw, w, [("cb", cb, cw.shape, cw.dtype),
                      ("b", b, w.shape, w.dtype)])
    if x.device.type == "cpu":
        return adaln_modulate_ref(x, cw, cb, w, b, eps)
    x, cw, cb, w, b = (t.contiguous() for t in (x, cw, cb, w, b))
    B, T, E = x.shape
    out = torch.empty_like(x)
    plan = device_plan(False, B, T, E, x.dtype,
                       _aligned(x, out, cw, cb, w, b), x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _library()[0](
        x.data_ptr(), cw.data_ptr(), cb.data_ptr(), w.data_ptr(),
        b.data_ptr(), out.data_ptr(), B, T, E, eps, _KIND[x.dtype],
        _KIND[w.dtype], plan.vec, plan.n, plan.wpr, plan.nb, stream)
    if rc != 0:
        raise RuntimeError(f"fused AdaLN forward kernel launch failed: CUDA "
                           f"error {rc}")
    global fwd_launches, fwd_launches_bf16
    fwd_launches += 1
    fwd_launches_bf16 += int(x.dtype == torch.bfloat16)
    return out


def adaln_bwd(x, cw, g, w, eps: float = LN_EPS):
    """Backward kernel: (dx [B, T, E] in x's dtype, dcw [B, 1, E], dcb
    [B, 1, E], dw [E], db [E], all four f32), one launch (the plain
    version for CPU tensors)."""
    _check(x, cw, w, [("g", g, x.shape, x.dtype)])
    if x.device.type == "cpu":
        return adaln_bwd_ref(x, cw, g, w, eps)
    x, cw, g, w = (t.contiguous() for t in (x, cw, g, w))
    B, T, E = x.shape
    dev = x.device
    dx = torch.empty_like(x)
    plan = device_plan(True, B, T, E, x.dtype, _aligned(x, g, dx, cw, w),
                       dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dgw, dgb = torch.empty((B, 1, E), **f32), torch.empty((B, 1, E), **f32)
    dw, db = torch.empty(E, **f32), torch.empty(E, **f32)
    # The clusters' partial column sums, [B, clusters, 2, E].
    part = torch.empty((B, plan.nb // plan.cs, 2, E), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    count = _counters(dev, stream)
    rc = _library()[1](
        x.data_ptr(), cw.data_ptr(), g.data_ptr(), w.data_ptr(),
        dx.data_ptr(), dgw.data_ptr(), dgb.data_ptr(), dw.data_ptr(),
        db.data_ptr(), part.data_ptr(), count.data_ptr(), B, T, E, eps,
        _KIND[x.dtype], _KIND[w.dtype], plan.vec, plan.n, plan.wpr, plan.nb,
        plan.cs, stream)
    if rc != 0:
        raise RuntimeError(f"fused AdaLN backward kernel launch failed: CUDA "
                           f"error {rc}")
    global bwd_launches, bwd_launches_bf16
    bwd_launches += 1
    bwd_launches_bf16 += int(x.dtype == torch.bfloat16)
    return dx, dgw, dgb, dw, db


def fused_supported(x, cw, cb) -> bool:
    """Where the JAX package takes its fused kernel: x [B, T, E] with
    time-constant cond [B, 1, E]. (Its E % 128 and T >= 8 conditions are
    layout rules of the TPU compiler and are not carried over.)"""
    return (torch.is_tensor(cw) and torch.is_tensor(cb) and x.dim() == 3
            and cw.dim() == 3 and cw.shape[1] == 1 and cb.shape == cw.shape
            and cw.shape[0] == x.shape[0] and cw.shape[2] == x.shape[2])


class _FusedAdaLN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cw, cb, w, b, eps):
        ctx.save_for_backward(x, cw, w)
        ctx.eps = eps
        return adaln_fwd(x, cw, cb, w, b, eps)

    @staticmethod
    def backward(ctx, g):
        x, cw, w = ctx.saved_tensors
        dx, dgw, dgb, dw, db = adaln_bwd(x, cw, g, w, ctx.eps)
        return (dx, dgw.to(cw.dtype), dgb.to(cw.dtype), dw.to(w.dtype),
                db.to(w.dtype), None)


def fused_adaln_modulate(x, cw, cb, w, b, eps: float = LN_EPS):
    """x: [B, T, E]; cw, cb: [B, 1, E]; w, b: [E] -> [B, T, E]. CPU
    tensors take the plain version; CUDA tensors the CUDA kernels."""
    if x.device.type == "cpu":
        return adaln_modulate_ref(x, cw, cb, w, b, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_adaln_modulate runs on CPU or CUDA "
                         f"tensors, not {x.device}")
    return _FusedAdaLN.apply(x, cw, cb, w, b, eps)
