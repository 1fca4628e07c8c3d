"""Single-token cache attention for the rollout step (flash-decode).

``decode_attention`` is the wrapper of the hand-written CUDA kernel
``sea_tpu_torch/csrc/decode_attention.cu``, which replaces the Pallas TPU
kernel ``sea_tpu/ops/decode_attention.py::_decode_kernel``. For a tensor on
the CPU it computes the plain PyTorch version, ``decode_attention_ref``;
for a CUDA tensor it launches the kernel once or raises. The kernel splits
each (b, h)'s keys over the blocks of a thread-block cluster and merges
them there; its grid comes from ``decode_plan``, a pure function of T,
B*H, hd, the cache dtype and the card (read once, ``device_plan``).

Semantics (both versions): softmax(q . K[:t+1]^T / sqrt(hd)) . V[:t+1] for
one query per (b, h) over a head-major [B, H, T, hd] f32 or bf16 cache, f32
accumulation, f32 [B, H, hd] out; q is cast to the cache dtype and the
unnormalised probabilities to the value dtype before p . V, each against
the running max of the TPU kernel's 256-key tiles up to its own, as the
TPU kernel does (``_tile_softmax_terms``).

An int8 cache (``k_scale``/``v_scale`` given: per-token f32 scales
[B, H, T]) takes the int8 variant of the same source, which replaces
``_decode_kernel_q8``; its plain version is ``decode_attention_q8_ref``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

# Launches of the CUDA kernel through ``decode_attention`` (a call on the
# CPU does not count). Read and reset by chip_smoke.py.
launches = 0
launches_q8 = 0

# 8 and 16: the smoke presets (cylinder_flow_smoke).
HEAD_DIMS = (8, 16, 64, 128, 256)
# The kernel's geometry (csrc/decode_attention.cu): at most 8 blocks a
# cluster (kMaxCluster, the portable limit) split the keys of a (b, h),
# none with fewer than 16 keys unless T is shorter; a block's shared
# memory holds its whole chunk of keys (K and V rows, the int8 scales and a
# score each) when that takes at most RING_BYTES, so that two blocks fit an
# SM, else a ring of two stages of half that.
MAX_CLUSTER = 8
MIN_KEYS_PER_SPLIT = 16
RING_BYTES = 104 * 1024
# The TPU kernel's key block past 256 keys (block_k = min(256, max(128,
# T))): its online softmax rounds each probability against the running
# max over these tiles, and both versions here round at that max.
TILE = 256
_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


class DecodePlan(NamedTuple):
    """splits blocks of a cluster, each taking chunk keys of a (b, h),
    through a ring of ``slots`` (1 or 2) stages of ``stage`` keys."""
    splits: int
    chunk: int
    stage: int
    slots: int


def key_bytes(hd: int, dtype) -> int:
    """Shared memory a key takes in the kernel's ring: its K and V rows,
    its two int8 scales and its score."""
    return 2 * hd * dtype.itemsize + (8 if dtype == torch.int8 else 0) + 4


def decode_plan(T: int, bh: int, hd: int, dtype, sm_count: int,
                cluster_slots=None) -> DecodePlan:
    """The kernel's grid for a [B*H = bh, T, hd] cache of ``dtype``: enough
    (b, h, split) blocks for about two per SM, at most MAX_CLUSTER splits,
    none shorter than MIN_KEYS_PER_SPLIT keys; the ring holds a whole
    chunk when it fits in RING_BYTES, else two stages. Fixed by T, not by
    the position, so every step of a rollout launches the same grid.
    ``cluster_slots(plan)``, where given, is how many clusters of the plan
    the card holds at once (``device_plan`` asks the card): the splits
    shrink until all bh clusters run at once, or, where no plan does, to
    the most that fit the card at all."""
    row = key_bytes(hd, dtype)
    want = max(1, math.ceil(2 * sm_count / bh))
    plans = []
    for splits in range(max(1, min(want, MAX_CLUSTER,
                                   T // MIN_KEYS_PER_SPLIT)), 0, -1):
        chunk = math.ceil(T / splits)
        if math.ceil(T / chunk) != splits:
            continue  # the same chunk as a smaller count
        if chunk * row <= RING_BYTES:
            plans.append(DecodePlan(splits, chunk, chunk, 1))
        else:
            plans.append(DecodePlan(splits, chunk,
                                    RING_BYTES // (2 * row), 2))
    if cluster_slots is None:
        return plans[0]
    slots = [cluster_slots(p) for p in plans]
    for plan, n in zip(plans, slots):
        if n >= bh:
            return plan
    for plan, n in zip(plans, slots):
        if n >= 1:
            return plan
    raise RuntimeError(f"decode kernel: no cluster of {plans} fits the card "
                       f"(T={T}, hd={hd}, {dtype})")


def _tile_softmax_terms(s):
    """s: f32 [..., T] scores, -inf at masked keys. Returns (p, w): the
    TPU kernel's unnormalised probability of each key, exp(s - m), m the
    running max over the TILE-key tiles up to and including the key's
    own (its online softmax over key blocks), and w = exp(m - M), M the
    max over all keys, which brings every term to one max. Key 0 is
    never masked, so every m is finite."""
    T = s.shape[-1]
    nt = -(-T // TILE)
    tiles = torch.nn.functional.pad(s, (0, nt * TILE - T),
                                    value=float("-inf"))
    tile_max = tiles.reshape(*s.shape[:-1], nt, TILE).amax(dim=-1)
    run_max = torch.cummax(tile_max, dim=-1).values
    m = run_max.repeat_interleave(TILE, dim=-1)[..., :T]
    p = torch.where(s == float("-inf"), 0.0, torch.exp(s - m))
    return p, torch.exp(m - run_max[..., -1:])


def decode_attention_ref(q, cache_k, cache_v, t):
    """Plain version. q: [B, H, hd]; cache_k/v: [B, H, T, hd]; t: int or
    int tensor of one element (on the cache's device). Returns f32
    [B, H, hd]. q is rounded to the cache dtype; each unnormalised
    probability (``_tile_softmax_terms``) is rounded to the value dtype
    before it multiplies V, the denominator sums them unrounded: where
    and against what max the TPU kernel rounds."""
    hd = q.shape[-1]
    T = cache_k.shape[2]
    qc = q.to(cache_k.dtype).float()
    s = torch.einsum("bhd,bhkd->bhk", qc, cache_k.float()) * hd ** -0.5
    pos = torch.arange(T, device=cache_k.device)
    s = s.masked_fill(pos > torch.as_tensor(t, device=cache_k.device)
                      .reshape(-1), float("-inf"))
    p, w = _tile_softmax_terms(s)
    out = torch.einsum("bhk,bhkd->bhd", p.to(cache_v.dtype).float() * w,
                       cache_v.float())
    return out / (p * w).sum(dim=-1, keepdim=True)


def decode_attention_q8_ref(q, cache_k, cache_v, k_scale, v_scale, t):
    """Plain version of the int8 kernel. q: [B, H, hd]; cache_k/v: int8
    [B, H, T, hd]; k_scale/v_scale: f32 [B, H, T]; t as for
    decode_attention_ref. q is rounded to bf16; the score of key t' is
    (q . k) * hd^-0.5 * k_scale[t']; the unnormalised probability
    (``_tile_softmax_terms``) times v_scale[t'] is rounded to bf16 before
    it multiplies V; the denominator sums the probabilities alone.
    Returns f32 [B, H, hd]."""
    hd = q.shape[-1]
    T = cache_k.shape[2]
    qb = q.to(torch.bfloat16).float()
    s = torch.einsum("bhd,bhkd->bhk", qb, cache_k.float()) * hd ** -0.5
    s = s * k_scale
    pos = torch.arange(T, device=cache_k.device)
    valid = pos <= torch.as_tensor(t, device=cache_k.device).reshape(-1)
    s = torch.where(valid, s, float("-inf"))
    p, w = _tile_softmax_terms(s)
    pv = torch.where(valid, p * v_scale, 0.0).to(torch.bfloat16).float() * w
    out = torch.einsum("bhk,bhkd->bhd", pv, cache_v.float())
    return out / (p * w).sum(dim=-1, keepdim=True)


@functools.cache
def _library():
    """The C entries, built at first use. Every pointer and the stream are
    c_void_p: ctypes would otherwise pass a Python int as a 32-bit int."""
    from sea_tpu_torch.ops._build import load_library
    lib = load_library("decode_attention")
    fn = lib.sea_decode_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn_q8 = lib.sea_decode_attention_q8
    fn_q8.restype = ctypes.c_int
    fn_q8.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                      + [ctypes.c_void_p])
    lib.sea_decode_cluster_slots.restype = ctypes.c_int
    lib.sea_decode_cluster_slots.argtypes = [ctypes.c_int] * 7
    return fn, fn_q8, lib.sea_decode_cluster_slots


@functools.lru_cache(maxsize=None)
def device_plan(T: int, bh: int, hd: int, dtype, dev) -> DecodePlan:
    """The plan the kernel runs at on CUDA device ``dev``: decode_plan with
    the device's SM count and its cluster occupancy
    (cudaOccupancyMaxActiveClusters) of each candidate. Cached: the
    rollout asks on every call."""
    dev = torch.device(dev)
    query = _library()[2]

    def cluster_slots(plan):
        with torch.cuda.device(dev):
            n = query(_KIND[dtype], hd, T, *plan)
        if n < 0:
            raise RuntimeError(f"decode kernel: cluster occupancy query "
                               f"failed on {dev} for {plan}")
        return n

    return decode_plan(T, bh, hd, dtype, torch.cuda.get_device_properties(
        dev).multi_processor_count, cluster_slots)


def _check(q, cache_k, cache_v, t, scales):
    if q.dim() != 3 or cache_k.dim() != 4:
        raise ValueError(f"want q [B,H,hd] and caches [B,H,T,hd]; got "
                         f"{tuple(q.shape)} and {tuple(cache_k.shape)}")
    B, H, hd = q.shape
    if cache_k.shape[:2] != (B, H) or cache_k.shape[3] != hd \
            or cache_v.shape != cache_k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(cache_k.shape)}, v {tuple(cache_v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    want = (torch.int8,) if scales else (torch.float32, torch.bfloat16)
    if cache_k.dtype not in want or cache_v.dtype != cache_k.dtype:
        raise ValueError(f"cache dtypes {cache_k.dtype}/{cache_v.dtype}: "
                         f"want both of one of {want}"
                         + ("" if scales else " (int8 needs k_scale and "
                            "v_scale)"))
    named = [("q", q), ("cache_k", cache_k), ("cache_v", cache_v)]
    for i, sc in enumerate(scales):
        named.append((("k_scale", "v_scale")[i], sc))
        if sc.shape != cache_k.shape[:3] or sc.dtype != torch.float32:
            raise ValueError(f"scales must be f32 [B, H, T]; got "
                             f"{sc.dtype} {tuple(sc.shape)}")
    for name, x in named:
        if x.device != cache_k.device:
            raise ValueError(f"{name} is on {x.device}, the cache on "
                             f"{cache_k.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 \
            or t.numel() != 1 or t.device != cache_k.device:
        raise ValueError(f"t must be an int32 tensor of one element on the "
                         f"cache's device; got {t!r}")


def decode_attention(q, cache_k, cache_v, t, *, k_scale=None, v_scale=None):
    """q: [B, H, hd]; cache_k/v: [B, H, T, hd]; t: the position, an int32
    tensor of one element on the cache's device, read by the kernel on the
    device (positions outside [0, T) are clamped there). Returns f32
    [B, H, hd]. CPU tensors take the plain version; CUDA tensors the
    kernel.

    k_scale/v_scale: f32 [B, H, T] per-token scales of an int8 cache
    (ops/attention.init_kv_cache); with them the int8 kernel (or its plain
    version) folds the scales into the score and probability math."""
    scales = () if k_scale is None else (k_scale, v_scale)
    if (k_scale is None) != (v_scale is None):
        raise ValueError("give both k_scale and v_scale, or neither")
    if cache_k.device.type == "cpu":
        if scales:
            return decode_attention_q8_ref(q, cache_k, cache_v, k_scale,
                                           v_scale, t)
        return decode_attention_ref(q, cache_k, cache_v, t)
    if cache_k.device.type != "cuda":
        raise ValueError(f"decode_attention runs on CPU or CUDA tensors, "
                         f"not {cache_k.device}")
    _check(q, cache_k, cache_v, t, scales)
    fn, fn_q8, _ = _library()
    B, H, T, hd = cache_k.shape
    dev = cache_k.device
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"cache on {dev}, but the current CUDA device is "
                         f"{torch.cuda.current_device()}: the kernel "
                         "launches on the current device")
    plan = device_plan(T, B * H, hd, cache_k.dtype, dev)
    q32 = q.float()
    out = torch.empty((B, H, hd), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (q32.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr())
    tail = (t.data_ptr(), out.data_ptr(), B * H, T, hd, *plan)
    global launches, launches_q8
    if scales:
        rc = fn_q8(*ptrs, k_scale.data_ptr(), v_scale.data_ptr(), *tail,
                   stream)
    else:
        rc = fn(*ptrs, *tail, int(cache_k.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {rc}")
    if scales:
        launches_q8 += 1
    else:
        launches += 1
    return out
