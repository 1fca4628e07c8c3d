"""Flash attention with in-kernel dropout for the training step.

``flash_attention`` is the wrapper of the hand-written CUDA kernels in
``sea_tpu_torch/csrc/flash_attention.cu`` — a forward that also returns
the row log-sum-exp, a dQ kernel and a dK/dV kernel — which replace the
Pallas TPU kernels ``_fwd_kernel``, ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel`` of ``sea_tpu/ops/flash_attention.py``, each in an f32
form and a bf16 form. On a CUDA tensor it runs the forward kernel inside
a ``torch.autograd.Function`` whose backward launches the two backward
kernels; on a CPU tensor it computes the plain PyTorch version,
``flash_attention_ref`` (below).

Semantics (both versions): q [B, Tq, H, hd], k/v [B, Tk, H, hd], all f32
or all bf16; scores q.k^T * hd^-0.5 in f32, masked to k <= q + src_len
when causal; f32 softmax statistics; then the inverted dropout scale
M(bh, q, k) in {0, 1/(1-rate)} multiplies the probabilities before p.V.
M comes from the position hash ``layers.dropout_scale_from_positions``
keyed on the two seed words, bh = b*H + h and the global q and k
positions — the function the TPU kernels compute, so the masks equal the
JAX package's bit for bit. A sharded call (``sea_tpu_torch/parallel``)
names the global rows and positions, as the TPU kernels' ``bh_map`` and
seed words 2-3 do: ``bh_map`` (int32 [B*H], local row -> global b*H + h;
default the identity) and ``pos_off`` = (q_off, k_off), added to the q
and k positions the hash sees (default (0, 0)). The causal band stays on
local positions. Every function below takes both, kernels and plain
versions alike. The backward identity D = rowsum(dO * O)
holds with dropout; D is computed here with torch in f32, outside the
kernels, as the JAX package does.

In bf16 the products take bf16 operands with f32 sums, and values are
rounded to bf16 where the TPU kernels round them: the unnormalised
exp(s - m) M to v's dtype before P.V (the output divided by the f32
denominator after it, then rounded to q's dtype), dS to k's dtype before
dS.K (dQ) and to q's dtype before dS^T.Q (dK), P.M to dO's dtype before
(P.M)^T.dO (dV); lse stays f32 and each gradient comes back in its
input's dtype. The TPU and CUDA kernels round p under the running max of
the key tiles seen so far (the bf16 CUDA forward at hd 64 to 256: of the
even or the odd tiles, which its two consumer groups walk apart before
merging in f32), the plain version under the row's final max: the same
rounding at another scale, so the two differ by bf16 rounding noise,
within the tests' tolerances. In f32 ``flash_attention_ref`` is
differentiated by autograd; in bf16 it runs the plain forward and
backward pieces (``flash_forward_ref``, ``flash_bwd_dq_ref``,
``flash_bwd_dkv_ref``) inside the kernels' autograd Function, so its
gradients round where the kernels' do.

What bounds the kernels on the card, and their design: see the note at
the top of the CUDA source. Head dims 8, 16 (the smoke presets), 64, 128
and 256; any other raises on CUDA. Alignment: the kernels copy q, k, v
and dO rows into shared memory in 16-byte pieces (``cp.async``; the bf16
forward at hd 64 to 256 through TMA tensor maps, which ask the same), so
on CUDA each of them must start on 16 bytes and its batch, time and head
strides must be whole multiples of 16 bytes: 4 floats or 8 bf16 (a dim of
size 1 is exempt: its stride is never used). A q, k or v view that breaks this raises
``ValueError``; nothing is copied to fix it. The views
``ops.attention.mha`` passes, fused qkv / kv column slices included, keep
it whenever the model width is a multiple of 8. dO comes from autograd
in whatever layout (and, in principle, dtype) the graph gives, so a dO
that breaks it is copied to a contiguous tensor of q's dtype instead.

``dropout_mask_dense`` writes that mask as a dense [BH, Tq, Tk] tensor
with a fourth kernel of the same source (replacing the TPU mask kernel
``_mask_kernel``), the oracle of the dropout verification; its plain
version is ``dropout_mask_dense_ref``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sea_tpu_torch.ops.layers import (dropout_keep_threshold,
                                      dropout_scale_from_positions)

# Launches of each CUDA kernel, f32 and bf16 forms apart (a CPU call does
# not count). Read and reset by chip_smoke.py.
fwd_launches = 0
dq_launches = 0
dkv_launches = 0
fwd_launches_bf16 = 0
dq_launches_bf16 = 0
dkv_launches_bf16 = 0
mask_launches = 0

# The element types the kernels take (q, k, v and dO of one of them).
DTYPES = (torch.float32, torch.bfloat16)

# 8 and 16: the smoke presets (cylinder_flow_smoke).
HEAD_DIMS = (8, 16, 64, 128, 256)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _valid(Tq, Tk, causal, src_len, device):
    """[Tq, Tk] bool: key k admitted for query q."""
    qi = torch.arange(Tq, device=device)[:, None]
    kj = torch.arange(Tk, device=device)[None, :]
    if not causal:
        return torch.ones((Tq, Tk), dtype=torch.bool, device=device)
    return kj <= qi + src_len


def dropout_mask_dense_ref(bh_map, Tq, Tk, seed, rate, pos_off=None):
    """Plain version of the dense mask kernel: [BH, Tq, Tk] f32 scale,
    row bh hashed with the global bh_map[bh], positions shifted by
    pos_off = (q_off, k_off)."""
    q_off, k_off = pos_off or (0, 0)
    dev = bh_map.device
    bh = bh_map.to(torch.int64).reshape(-1, 1, 1)
    qp = torch.arange(Tq, device=dev).reshape(1, Tq, 1) + int(q_off)
    kp = torch.arange(Tk, device=dev).reshape(1, 1, Tk) + int(k_off)
    return dropout_scale_from_positions(seed[0], seed[1], bh, qp, kp,
                                        rate=rate)


def dropout_mask(B, H, Tq, Tk, seed, rate, device, bh_map=None,
                 pos_off=None):
    """[B, H, Tq, Tk] f32 dropout scale of the kernels: row b*H + h hashes
    with bh_map[b*H + h] (default b*H + h), positions with pos_off."""
    bh = (torch.arange(B * H, device=device) if bh_map is None
          else bh_map.to(device))
    return dropout_mask_dense_ref(bh, Tq, Tk, seed, rate, pos_off).reshape(
        B, H, Tq, Tk)


def _scores(q, k, causal, src_len):
    """[B, H, Tq, Tk] f32 scores q.k^T * hd^-0.5, -inf outside the band."""
    Tq, hd, Tk = q.shape[1], q.shape[3], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5
    return s.masked_fill(~_valid(Tq, Tk, causal, src_len, q.device),
                         float("-inf"))


def flash_attention_ref(q, k, v, *, causal: bool = True, src_len: int = 0,
                        dropout_rate: float = 0.0, dropout_seed=None,
                        bh_map=None, pos_off=None):
    """Plain version: materialises the [B, H, Tq, Tk] scores and mask.
    f32: differentiable by autograd. bf16: the plain forward and backward
    pieces inside the kernels' autograd Function, so its gradients round
    where the kernels' do (autograd through the rounded forward would
    differentiate the roundings instead: the D = rowsum(dO O) identity of
    the kernels holds for the exact O only)."""
    if q.dtype != torch.float32:
        seed = tuple(dropout_seed) if dropout_rate > 0.0 else None
        return _FlashAttention.apply(q, k, v, bool(causal), int(src_len),
                                     float(dropout_rate), seed, bh_map,
                                     _offsets(pos_off), True)
    B, Tq, H, hd = q.shape
    Tk = k.shape[1]
    p = torch.softmax(_scores(q, k, causal, src_len), dim=-1)
    if dropout_rate > 0.0:
        p = p * dropout_mask(B, H, Tq, Tk, dropout_seed, dropout_rate,
                             q.device, bh_map, pos_off)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def flash_forward_ref(q, k, v, *, causal=True, src_len=0, dropout_rate=0.0,
                      dropout_seed=None, bh_map=None, pos_off=None):
    """The forward kernel's outputs: (o [B, Tq, H, hd] in q's dtype, lse
    [B*H, Tq] f32). In bf16, o = (round(exp(s - m) M) . v) / l with m the
    row max and l = sum exp(s - m)."""
    B, Tq, H, hd = q.shape
    Tk = k.shape[1]
    s = _scores(q, k, causal, src_len)
    lse = torch.logsumexp(s, dim=-1)
    if q.dtype == torch.float32:
        out = flash_attention_ref(q, k, v, causal=causal, src_len=src_len,
                                  dropout_rate=dropout_rate,
                                  dropout_seed=dropout_seed, bh_map=bh_map,
                                  pos_off=pos_off)
        return out, lse.reshape(B * H, Tq)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)  # the undropped p, as the kernels
    if dropout_rate > 0.0:
        p = p * dropout_mask(B, H, Tq, Tk, dropout_seed, dropout_rate,
                             q.device, bh_map, pos_off)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = out / den.permute(0, 2, 1, 3)
    return out.to(q.dtype), lse.reshape(B * H, Tq)


def _bwd_ref_pieces(q, k, v, do, lse, dsum, causal, src_len, dropout_rate,
                    dropout_seed, bh_map=None, pos_off=None):
    """(P * M, dS) [B, H, Tq, Tk] f32 of the backward, P from the
    forward's lse."""
    B, Tq, H, hd = q.shape
    Tk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5
    p = torch.exp(s - lse.reshape(B, H, Tq, 1))
    p = p.masked_fill(~_valid(Tq, Tk, causal, src_len, q.device), 0.0)
    m = (dropout_mask(B, H, Tq, Tk, dropout_seed, dropout_rate, q.device,
                      bh_map, pos_off)
         if dropout_rate > 0.0 else torch.ones_like(p))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p * m, p * (dp * m - dsum.reshape(B, H, Tq, 1))


def flash_bwd_dq_ref(q, k, v, do, lse, dsum, *, causal=True, src_len=0,
                     dropout_rate=0.0, dropout_seed=None, bh_map=None,
                     pos_off=None):
    """The dQ kernel's output, in q's dtype, from the forward's lse and D
    [B*H, Tq]; dS rounded to k's dtype before dS.K."""
    _, ds = _bwd_ref_pieces(q, k, v, do, lse, dsum, causal, src_len,
                            dropout_rate, dropout_seed, bh_map, pos_off)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                      k.float()) * q.shape[3] ** -0.5
    return dq.to(q.dtype)


def flash_bwd_dkv_ref(q, k, v, do, lse, dsum, *, causal=True, src_len=0,
                      dropout_rate=0.0, dropout_seed=None, bh_map=None,
                      pos_off=None):
    """The dK/dV kernel's outputs (dk, dv) in k's and v's dtypes; dS
    rounded to q's dtype before dS^T.Q, P.M to dO's before (P.M)^T.dO."""
    pm, ds = _bwd_ref_pieces(q, k, v, do, lse, dsum, causal, src_len,
                             dropout_rate, dropout_seed, bh_map, pos_off)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(),
                      q.float()) * q.shape[3] ** -0.5
    dv = torch.einsum("bhqk,bqhd->bkhd", pm.to(do.dtype).float(), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def row_dot(do, o):
    """D = rowsum(dO * O) as [B*H, Tq] f32: the backward's input that the
    JAX package, too, computes outside its kernels."""
    B, Tq, H, _ = o.shape
    d = (do.float() * o.float()).sum(-1)  # [B, Tq, H]
    return d.permute(0, 2, 1).reshape(B * H, Tq).contiguous()


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

@functools.cache
def _library():
    """The C entries, built at first use: f32 and bf16 forms of the
    forward, dQ and dK/dV (the same arguments), and the mask. Pointers
    and the stream are c_void_p and strides c_longlong: ctypes would
    otherwise pass a Python int as a 32-bit int."""
    from sea_tpu_torch.ops._build import load_library
    lib = load_library("flash_attention")
    P, L = ctypes.c_void_p, ctypes.c_longlong
    view = [P, L, L, L]
    shape = ([ctypes.c_int] * 7 + [ctypes.c_uint32] * 3
             + [ctypes.c_float, ctypes.c_int, P, ctypes.c_int, ctypes.c_int,
                P])
    fns = {}
    for suffix in ("", "_bf16"):
        fns.update({
            "fwd" + suffix: (getattr(lib, "sea_flash_fwd" + suffix),
                             view * 3 + [P, P] + shape),
            "dq" + suffix: (getattr(lib, "sea_flash_bwd_dq" + suffix),
                            view * 4 + [P, P, P] + shape),
            "dkv" + suffix: (getattr(lib, "sea_flash_bwd_dkv" + suffix),
                             view * 4 + [P, P, P, P] + shape)})
    fns["mask"] = (lib.sea_dropout_mask,
                   [P, P] + [ctypes.c_int] * 3 + [ctypes.c_uint32] * 3
                   + [ctypes.c_float, P])
    for fn, argtypes in fns.values():
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return {name: fn for name, (fn, _) in fns.items()}


def _entry(kind, dtype):
    """The C entry of kernel `kind` ("fwd", "dq", "dkv") for dtype."""
    return _library()[kind + ("_bf16" if dtype == torch.bfloat16 else "")]


def _count(kind, dtype):
    """One more launch of kernel `kind` in dtype's form."""
    name = f"{kind}_launches" + ("_bf16" if dtype == torch.bfloat16 else "")
    globals()[name] += 1


def _view(x):
    return [x.data_ptr(), x.stride(0), x.stride(1), x.stride(2)]


def _misaligned(x):
    """Why x [B, T, H, hd] breaks the kernels' 16-byte cp.async row copies
    (start on 16 bytes; batch, time and head strides multiples of 16
    bytes, dims of size 1 exempt), or None."""
    if x.data_ptr() % 16:
        return f"starts {x.data_ptr() % 16} bytes past a 16-byte boundary"
    step = 16 // x.element_size()
    for dim, what in enumerate(("batch", "time", "head")):
        if x.shape[dim] > 1 and x.stride(dim) % step:
            return (f"{what} stride {x.stride(dim)} is not a multiple of "
                    f"{step} elements of {x.dtype}")
    return None


def _check_aligned(name, x):
    """Raise ValueError if x breaks the 16-byte rule (``_misaligned``)."""
    why = _misaligned(x)
    if why:
        raise ValueError(f"{name}: {why}; the kernels copy rows in 16-byte "
                         "pieces")


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q [B,Tq,H,hd] and k, v [B,Tk,H,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, hd = q.shape
    if k.shape[0] != B or k.shape[2:] != (H, hd):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if q.dtype not in DTYPES:
        raise ValueError(f"q is {q.dtype}; the kernels take {DTYPES}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype}, q {q.dtype}: the "
                             "kernels take one dtype for q, k and v")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.stride(3) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous")
        _check_aligned(name, x)
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {q.device}, but the current CUDA "
                         f"device is {torch.cuda.current_device()}: the "
                         "kernels launch on the current device")


def _offsets(pos_off):
    """(q_off, k_off) as two ints; None is (0, 0)."""
    q_off, k_off = pos_off or (0, 0)
    return int(q_off), int(k_off)


def _check_bh_map(bh_map, q):
    """bh_map as the kernels read it: None, or int32 [B*H] contiguous on
    q's device."""
    if bh_map is None:
        return None
    B, _, H, _ = q.shape
    if bh_map.shape != (B * H,) or bh_map.dtype != torch.int32 \
            or not bh_map.is_contiguous() or bh_map.device != q.device:
        raise ValueError(f"bh_map must be contiguous int32 [{B * H}] on "
                         f"{q.device}; got {bh_map.dtype} "
                         f"{tuple(bh_map.shape)} on {bh_map.device}")
    return bh_map


def _shape_args(q, k, causal, src_len, dropout_rate, dropout_seed,
                bh_map=None, pos_off=None):
    B, Tq, H, hd = q.shape
    if dropout_rate > 0.0:
        s0, s1 = (w & 0xFFFFFFFF for w in dropout_seed)
        threshold = dropout_keep_threshold(dropout_rate)
        inv = float(torch.tensor(1.0 / (1.0 - dropout_rate),
                                 dtype=torch.float32))
    else:
        s0 = s1 = threshold = 0
        inv = 1.0
    bh_map = _check_bh_map(bh_map, q)
    return [B, H, Tq, k.shape[1], hd, int(causal), src_len, s0, s1,
            threshold, inv, int(dropout_rate > 0.0),
            None if bh_map is None else bh_map.data_ptr(),
            *_offsets(pos_off),
            torch.cuda.current_stream(q.device).cuda_stream]


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"flash attention {name} kernel launch failed: "
                           f"CUDA error {rc}")


def flash_fwd(q, k, v, *, causal=True, src_len=0, dropout_rate=0.0,
              dropout_seed=None, bh_map=None, pos_off=None):
    """Forward kernel: (o [B, Tq, H, hd] contiguous in q's dtype, lse
    [B*H, Tq] f32)."""
    _check(q, k, v)
    B, Tq, H, hd = q.shape
    o = torch.empty((B, Tq, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, Tq), dtype=torch.float32, device=q.device)
    rc = _entry("fwd", q.dtype)(
        *_view(q), *_view(k), *_view(v), o.data_ptr(), lse.data_ptr(),
        *_shape_args(q, k, causal, src_len, dropout_rate, dropout_seed,
                     bh_map, pos_off))
    _raise_on(rc, "forward")
    _count("fwd", q.dtype)
    return o, lse


def _grad_input(do, dtype=torch.float32):
    """dO as the backward kernels read it: in q's dtype, hd contiguous and
    within the 16-byte rule. Autograd may hand any layout, so a dO that
    breaks the rule is copied to a contiguous tensor rather than
    refused."""
    if do.dtype != dtype or do.stride(3) != 1 or _misaligned(do):
        return do.to(dtype).contiguous()
    return do


def _bwd_inputs(q, k, v, do, lse, dsum):
    _check(q, k, v)
    if do.shape != q.shape:
        raise ValueError(f"dO is {tuple(do.shape)}, q {tuple(q.shape)}")
    do = _grad_input(do, q.dtype)
    B, Tq, H, _ = q.shape
    for name, x in (("lse", lse), ("dsum", dsum)):
        if x.shape != (B * H, Tq) or not x.is_contiguous() \
                or x.dtype != torch.float32 or x.device != q.device:
            raise ValueError(f"{name} must be contiguous f32 [B*H, Tq] on "
                             f"{q.device}")
    return do


def flash_bwd_dq(q, k, v, do, lse, dsum, *, causal=True, src_len=0,
                 dropout_rate=0.0, dropout_seed=None, bh_map=None,
                 pos_off=None):
    """dQ kernel: dq [B, Tq, H, hd] contiguous in q's dtype."""
    kw = dict(causal=causal, src_len=src_len, dropout_rate=dropout_rate,
              dropout_seed=dropout_seed, bh_map=bh_map, pos_off=pos_off)
    do = _bwd_inputs(q, k, v, do, lse, dsum)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    rc = _entry("dq", q.dtype)(
        *_view(q), *_view(k), *_view(v), *_view(do), lse.data_ptr(),
        dsum.data_ptr(), dq.data_ptr(), *_shape_args(q, k, **kw))
    _raise_on(rc, "dQ")
    _count("dq", q.dtype)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, dsum, *, causal=True, src_len=0,
                  dropout_rate=0.0, dropout_seed=None, bh_map=None,
                  pos_off=None):
    """dK/dV kernel: (dk, dv), each [B, Tk, H, hd] contiguous in q's dtype.
    Keys above the causal band get zeros."""
    kw = dict(causal=causal, src_len=src_len, dropout_rate=dropout_rate,
              dropout_seed=dropout_seed, bh_map=bh_map, pos_off=pos_off)
    do = _bwd_inputs(q, k, v, do, lse, dsum)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    rc = _entry("dkv", q.dtype)(
        *_view(q), *_view(k), *_view(v), *_view(do), lse.data_ptr(),
        dsum.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_shape_args(q, k, **kw))
    _raise_on(rc, "dK/dV")
    _count("dkv", q.dtype)
    return dk, dv


def dropout_mask_dense(BH: int, Tq: int, Tk: int, seed, rate: float, device,
                       bh_map=None):
    """The dropout scale {0, 1/(1-rate)} the flash kernels apply, as a dense
    f32 [BH, Tq, Tk] tensor on ``device``: row bh hashes with bh_map[bh]
    (default bh). The verification oracle of the kernels' dropout. On a
    CUDA device the mask kernel writes it; on the CPU the plain version.
    Unlike the TPU kernel, it returns the logical region, not one padded to
    block multiples."""
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate {rate} not in (0, 1)")
    device = torch.device(device)
    if bh_map is None:
        bh_map = torch.arange(BH, dtype=torch.int32, device=device)
    bh_map = bh_map.to(device=device, dtype=torch.int32).contiguous()
    if bh_map.shape != (BH,):
        raise ValueError(f"bh_map must be [{BH}]; got {tuple(bh_map.shape)}")
    if device.type == "cpu":
        return dropout_mask_dense_ref(bh_map, Tq, Tk, seed, rate)
    if device.type != "cuda":
        raise ValueError(f"dropout_mask_dense runs on CPU or CUDA, not "
                         f"{device}")
    if device.index is not None \
            and device.index != torch.cuda.current_device():
        raise ValueError(f"{device} is not the current CUDA device")
    out = torch.empty((BH, Tq, Tk), dtype=torch.float32, device=device)
    s0, s1 = (w & 0xFFFFFFFF for w in seed)
    inv = float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))
    rc = _library()["mask"](bh_map.data_ptr(), out.data_ptr(), BH, Tq, Tk,
                            s0, s1, dropout_keep_threshold(rate), inv,
                            torch.cuda.current_stream(device).cuda_stream)
    _raise_on(rc, "dropout mask")
    global mask_launches
    mask_launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """The kernels' forward and backward under autograd; ``plain``: their
    plain versions (the bf16 ``flash_attention_ref``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, src_len, dropout_rate, dropout_seed,
                bh_map=None, pos_off=(0, 0), plain=False):
        kw = dict(causal=causal, src_len=src_len, dropout_rate=dropout_rate,
                  dropout_seed=dropout_seed, bh_map=bh_map, pos_off=pos_off)
        o, lse = (flash_forward_ref if plain else flash_fwd)(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw, ctx.plain = kw, plain
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dsum = row_dot(do, o)
        dq_fn, dkv_fn = ((flash_bwd_dq_ref, flash_bwd_dkv_ref) if ctx.plain
                         else (flash_bwd_dq, flash_bwd_dkv))
        dq = dq_fn(q, k, v, do, lse, dsum, **ctx.kw)
        dk, dv = dkv_fn(q, k, v, do, lse, dsum, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention(q, k, v, causal: bool = True, src_len: int = 0, *,
                    dropout_rate: float = 0.0, dropout_seed=None,
                    bh_map=None, pos_off=None):
    """q: [B, Tq, H, hd]; k, v: [B, Tk, H, hd], f32 or bf16 ->
    [B, Tq, H, hd] in q's dtype.

    dropout_seed: the two int32 words of the dropout key
    (``utils.prng.key_to_seed``); required when dropout_rate > 0.
    bh_map, pos_off: the global rows and position offsets the dropout
    hash sees (module docstring). CUDA tensors take the kernels; CPU
    tensors the plain version, ``flash_attention_ref``."""
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("flash_attention: dropout_rate > 0 requires a "
                         "dropout_seed")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, src_len=src_len,
                                   dropout_rate=dropout_rate,
                                   dropout_seed=dropout_seed, bh_map=bh_map,
                                   pos_off=pos_off)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA tensors, "
                         f"not {q.device}")
    seed = tuple(dropout_seed) if dropout_rate > 0.0 else None
    return _FlashAttention.apply(q, k, v, bool(causal), int(src_len),
                                 float(dropout_rate), seed,
                                 _check_bh_map(bh_map, q), _offsets(pos_off))
