"""Fused AdaLN modulate for the training step: forward and backward.

``fused_adaln_modulate`` is the wrapper of two hand-written Triton kernels
(``fwd_kernel`` and ``bwd_kernel``, defined in ``_kernels`` below) that
replace the Pallas TPU kernels ``_fwd_kernel`` and ``_bwd_kernel`` of
``sea_tpu/ops/fused_adaln.py``. On a CUDA tensor it runs the forward
kernel inside a ``torch.autograd.Function`` whose backward launches the
backward kernel; on a CPU tensor it computes the plain PyTorch version,
``adaln_modulate_ref``, and autograd differentiates that.

Function (x [B, T, E]; time-constant cond cw, cb [B, 1, E]; base w, b
[E]; f32 row statistics, output in x's dtype):

    out = (x - mean) * rsqrt(var + eps) * (w + cw) + (b + cb)

with ``w + cw`` and ``b + cb`` rounded in the parameter dtype first, as
the TPU kernel does. Backward, per row (a = w + cw, xhat the normalised
row): dx = rstd * (g a - mean(g a) - xhat * mean(g a xhat)); per
trajectory dgw = sum_t g xhat and dgb = sum_t g, from which dcw = dgw,
dcb = dgb, dw = sum_b dgw and db = sum_b dgb.

What bounds it on the card: bytes. Each row is a normalisation and an
elementwise affine, a few operations per element read, so the forward
streams x in and out once and the backward reads x and g and writes dx
once. Design:
  - forward: one program per row of E (a power of two up to 1024 on the
    path), the row held in registers; statistics and affine in one pass.
  - backward: one program per (trajectory, chunk of CHUNK rows); it writes
    dx for its rows and its partial column sums of g*xhat and g to a
    [B, chunks, E] scratch, and a plain sum over the chunks finishes
    dgw/dgb — the TPU kernel's carried scratch, across blocks that run in
    no order, as a second pass instead of atomics, so the result does not
    depend on the order blocks finish in.
Triton is imported inside the launching functions only: the CPU
installation of this package has no triton.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

LN_EPS = 1e-5
# Rows per backward program.
CHUNK = 8

# Launches of each Triton kernel (a CPU call does not count). Read and
# reset by chip_smoke.py.
fwd_launches = 0
bwd_launches = 0


def fused_supported(x, cw, cb) -> bool:
    """Where the JAX package takes its fused kernel: x [B, T, E] with
    time-constant cond [B, 1, E]. (Its E % 128 and T >= 8 conditions are
    layout rules of the TPU compiler and are not carried over.)"""
    return (torch.is_tensor(cw) and torch.is_tensor(cb) and x.dim() == 3
            and cw.dim() == 3 and cw.shape[1] == 1 and cb.shape == cw.shape
            and cw.shape[0] == x.shape[0] and cw.shape[2] == x.shape[2])


def adaln_modulate_ref(x, cw, cb, w, b, eps: float = LN_EPS):
    """Plain version (the formula of ``ops.layers.adaln_modulate``)."""
    xf = x.float()
    xhat = F.layer_norm(xf, (xf.shape[-1],), eps=eps)
    return (xhat * (w + cw) + (b + cb)).to(x.dtype)


def adaln_bwd_ref(x, cw, g, w, eps: float = LN_EPS):
    """The backward kernel's outputs: (dx, dgw [B, 1, E], dgb [B, 1, E]),
    written out as the TPU kernel computes them."""
    xf, gf = x.float(), g.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xhat = xc * rstd
    dxhat = gf * (w + cw).float()
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return (dx.to(x.dtype), (gf * xhat).sum(1, keepdim=True),
            gf.sum(1, keepdim=True))


@functools.cache
def _kernels():
    """The two Triton kernels, defined at first use."""
    import triton
    import triton.language as tl

    @triton.jit
    def fwd_kernel(x_ptr, cw_ptr, cb_ptr, w_ptr, b_ptr, o_ptr, T, E, eps,
                   BLOCK_E: tl.constexpr):
        row = tl.program_id(0)  # b * T + t
        traj = row // T
        cols = tl.arange(0, BLOCK_E)
        ok = cols < E
        x = tl.load(x_ptr + row * E + cols, mask=ok, other=0.0).to(
            tl.float32)
        mean = tl.sum(x, axis=0) / E
        xc = tl.where(ok, x - mean, 0.0)
        var = tl.sum(xc * xc, axis=0) / E
        xhat = xc * tl.rsqrt(var + eps)
        a = (tl.load(w_ptr + cols, mask=ok, other=0.0)
             + tl.load(cw_ptr + traj * E + cols, mask=ok, other=0.0))
        c = (tl.load(b_ptr + cols, mask=ok, other=0.0)
             + tl.load(cb_ptr + traj * E + cols, mask=ok, other=0.0))
        out = xhat * a.to(tl.float32) + c.to(tl.float32)
        tl.store(o_ptr + row * E + cols, out.to(o_ptr.dtype.element_ty),
                 mask=ok)

    @triton.jit
    def bwd_kernel(x_ptr, cw_ptr, g_ptr, w_ptr, dx_ptr, pgw_ptr, pgb_ptr,
                   T, E, n_chunks, eps, CHUNK: tl.constexpr,
                   BLOCK_E: tl.constexpr):
        traj = tl.program_id(0)
        chunk = tl.program_id(1)
        cols = tl.arange(0, BLOCK_E)
        ok = cols < E
        a = (tl.load(w_ptr + cols, mask=ok, other=0.0)
             + tl.load(cw_ptr + traj * E + cols, mask=ok, other=0.0)
             ).to(tl.float32)
        acc_gw = tl.zeros((BLOCK_E,), dtype=tl.float32)
        acc_gb = tl.zeros((BLOCK_E,), dtype=tl.float32)
        for i in range(CHUNK):
            t = chunk * CHUNK + i
            # Rows past T load as zeros and add nothing (masked loads,
            # not a multiply: no garbage can poison the sums).
            live = ok & (t < T)
            base = (traj * T + t) * E
            x = tl.load(x_ptr + base + cols, mask=live, other=0.0).to(
                tl.float32)
            g = tl.load(g_ptr + base + cols, mask=live, other=0.0).to(
                tl.float32)
            mean = tl.sum(x, axis=0) / E
            xc = tl.where(live, x - mean, 0.0)
            rstd = tl.rsqrt(tl.sum(xc * xc, axis=0) / E + eps)
            xhat = xc * rstd
            dxhat = g * a
            dx = rstd * (dxhat - tl.sum(dxhat, axis=0) / E
                         - xhat * (tl.sum(dxhat * xhat, axis=0) / E))
            tl.store(dx_ptr + base + cols, dx.to(dx_ptr.dtype.element_ty),
                     mask=live)
            acc_gw += g * xhat
            acc_gb += g
        part = (traj * n_chunks + chunk) * E
        tl.store(pgw_ptr + part + cols, acc_gw, mask=ok)
        tl.store(pgb_ptr + part + cols, acc_gb, mask=ok)

    return fwd_kernel, bwd_kernel


def _block(E: int) -> int:
    return 1 << max(0, (E - 1).bit_length())


def _check(x, cw, w):
    if not fused_supported(x, cw, cw):
        raise ValueError(f"fused AdaLN takes x [B,T,E] and cond [B,1,E]; "
                         f"got {tuple(x.shape)} and {tuple(cw.shape)}")
    if w.shape != (x.shape[2],):
        raise ValueError(f"base weight {tuple(w.shape)} for E={x.shape[2]}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"fused AdaLN takes float x, not {x.dtype}")
    if cw.device != x.device or w.device != x.device:
        raise ValueError(f"x on {x.device}, cond on {cw.device}, weight on "
                         f"{w.device}")
    if x.shape[2] > 16384:
        raise ValueError(f"E={x.shape[2]} exceeds the one-block row of the "
                         "Triton kernels")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"x on {x.device}, but the current CUDA device is "
                         f"{torch.cuda.current_device()}")


def adaln_fwd(x, cw, cb, w, b, eps: float = LN_EPS):
    """Forward kernel: out [B, T, E] in x's dtype."""
    _check(x, cw, w)
    x, cw, cb = x.contiguous(), cw.contiguous(), cb.contiguous()
    B, T, E = x.shape
    out = torch.empty_like(x)
    fwd_kernel, _ = _kernels()
    fwd_kernel[(B * T,)](x, cw, cb, w.contiguous(), b.contiguous(), out, T,
                         E, eps, BLOCK_E=_block(E), num_warps=4)
    global fwd_launches
    fwd_launches += 1
    return out


def adaln_bwd(x, cw, g, w, eps: float = LN_EPS):
    """Backward kernel plus the sum over chunks: (dx, dgw [B, 1, E] f32,
    dgb [B, 1, E] f32)."""
    _check(x, cw, w)
    x, cw, g = x.contiguous(), cw.contiguous(), g.contiguous()
    B, T, E = x.shape
    n_chunks = -(-T // CHUNK)
    dx = torch.empty_like(x)
    pgw = torch.empty((B, n_chunks, E), dtype=torch.float32, device=x.device)
    pgb = torch.empty_like(pgw)
    _, bwd_kernel = _kernels()
    bwd_kernel[(B, n_chunks)](x, cw, g, w.contiguous(), dx, pgw, pgb, T, E,
                              n_chunks, eps, CHUNK=CHUNK,
                              BLOCK_E=_block(E), num_warps=4)
    global bwd_launches
    bwd_launches += 1
    return dx, pgw.sum(1, keepdim=True), pgb.sum(1, keepdim=True)


class _FusedAdaLN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cw, cb, w, b, eps):
        ctx.save_for_backward(x, cw, w)
        ctx.eps = eps
        return adaln_fwd(x, cw, cb, w, b, eps)

    @staticmethod
    def backward(ctx, g):
        x, cw, w = ctx.saved_tensors
        dx, dgw, dgb = adaln_bwd(x, cw, g, w, ctx.eps)
        dw = dgw.sum((0, 1)).to(w.dtype)
        db = dgb.sum((0, 1)).to(w.dtype)
        return dx, dgw.to(cw.dtype), dgb.to(cw.dtype), dw, db, None


def fused_adaln_modulate(x, cw, cb, w, b, eps: float = LN_EPS):
    """x: [B, T, E]; cw, cb: [B, 1, E]; w, b: [E] -> [B, T, E]. CPU
    tensors take the plain version; CUDA tensors the Triton kernels."""
    if x.device.type == "cpu":
        return adaln_modulate_ref(x, cw, cb, w, b, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_adaln_modulate runs on CPU or CUDA "
                         f"tensors, not {x.device}")
    return _FusedAdaLN.apply(x, cw, cb, w, b, eps)
