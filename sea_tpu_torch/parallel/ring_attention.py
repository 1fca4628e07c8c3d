"""Ring attention: attention over a time axis split across the ranks of a
seq grid (``--seq_parallel N``), the port's counterpart of
``sea_tpu/parallel/ring_attention.py``.

Rank r holds the query, key and value block of time steps [r Tl,
(r+1) Tl). At ring step s it holds the key/value block that started on
rank (r - s) mod n; between steps every rank passes its current block on
to rank r + 1 (``collectives.ring_shift``), so after n steps each query
block has met every key block with only Tl keys resident at a time.

Two forms, chosen as the JAX function chooses them (``flash_ok``):

- flash (every shipped config: causal with src_len == 0, or non-causal):
  each live (query block, key block) pair runs the flash forward
  (``ops.flash_attention.flash_fwd``: the CUDA kernel on the card, its
  plain version ``flash_forward_ref`` on the CPU) with the pair's global
  offsets ``pos_off`` = (q_off, k_off), so the in-kernel dropout hashes
  the one-device positions; the diagonal pair is causal and the others
  are not. The pairs' (out, lse) merge by the log-sum-exp rule. A pair
  wholly above the diagonal is skipped and launches nothing, as the JAX
  ring's ``lax.cond`` skips it. The backward computes D = rowsum(dO O)
  once, then for each live pair the dQ and dK/dV kernels with the GLOBAL
  lse; the dK and dV sums travel with their key block, and one more
  shift brings them home. On a CUDA tensor the flash form always runs
  the kernels: no shape or dtype sends it to the plain versions.
- dense (causal with src_len != 0, which the JAX flash ring refuses):
  plain torch on every device, the plain flash pieces with each pair's
  band shifted to global positions (key k_off + j admitted for query
  q_off + i when j <= i + src_len + q_off - k_off) and the same
  global-position dropout hash, merged as the flash form merges; the JAX
  ring's ``_block_attend`` online softmax computes the same sums.

Both are one ``torch.autograd.Function``: the shifts of the backward run
in the same order on every rank whatever pairs a rank skips, which
autograd through the shifts could not promise. The merges and the
accumulations are elementwise torch code, as they are XLA code outside
the Pallas kernels in the JAX package. Dropout: rows b*H + h of the full
batch (a seq grid does not split the batch), positions global.
"""

from __future__ import annotations

import torch

from sea_tpu_torch.ops import flash_attention as FA
from sea_tpu_torch.parallel.collectives import Grid, ring_shift


def flash_ok(causal: bool, src_len: int) -> bool:
    """The JAX ring's ``_ring_flash_ok``: the flash form serves every
    ring but a causal one with src_len != 0."""
    return not (causal and src_len != 0)


def pair_geometry(s: int, idx: int, n: int, tl: int):
    """Global (q_off, k_off) of ring step s on rank idx: the query block
    at idx Tl, the key block that started on rank (idx - s) mod n."""
    return idx * tl, ((idx - s) % n) * tl


def _live(s, q_off, k_off, tl, causal, src_len):
    """Whether pair s has any admitted key (the JAX rings' predicates)."""
    if not causal or s == 0:
        return True
    return k_off <= q_off + tl - 1 + src_len


def _band(flash, causal, src_len, s, q_off, k_off):
    """The band of pair s in local positions: the flash form's diagonal
    pair is causal, its other live pairs full; the dense form's global
    band k <= q + src_len shifted to the pair's offsets."""
    if flash:
        return dict(causal=causal and s == 0, src_len=0)
    return dict(causal=causal, src_len=src_len + q_off - k_off)


def _rows(x, B, H, tl):
    """[B*H, Tl] row statistics as [B, Tl, H, 1] for [B, Tl, H, hd]."""
    return x.reshape(B, H, tl).permute(0, 2, 1).unsqueeze(-1)


def _combine(out_acc, lse_acc, out_b, lse_b):
    """The log-sum-exp merge of two normalised partial attentions
    (``_combine_blocks``): out [B, Tl, H, hd] f32, lse [B*H, Tl] f32. A
    row of the pair that admits no key (lse -inf; the plain pieces give
    it NaN) adds nothing."""
    B, tl, H, _ = out_acc.shape
    lse = torch.maximum(lse_acc, lse_b) + torch.log1p(
        torch.exp(-(lse_acc - lse_b).abs()))
    w_acc = torch.where(torch.isfinite(lse_acc), torch.exp(lse_acc - lse),
                        0.0)
    w_b = torch.where(torch.isfinite(lse_b), torch.exp(lse_b - lse), 0.0)
    term_b = torch.where(_rows(torch.isfinite(lse_b), B, H, tl),
                         out_b.float() * _rows(w_b, B, H, tl), 0.0)
    return out_acc * _rows(w_acc, B, H, tl) + term_b, lse


def _pieces(device, flash):
    """(forward, dQ, dK/dV): the CUDA kernels, or on the CPU (and in the
    dense form) their plain versions."""
    if device.type == "cpu" or not flash:
        return (FA.flash_forward_ref, FA.flash_bwd_dq_ref,
                FA.flash_bwd_dkv_ref)
    return FA.flash_fwd, FA.flash_bwd_dq, FA.flash_bwd_dkv


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, grid, causal, src_len, rate, seed, flash):
        n, idx, group = grid.n_seq, grid.seq_rank, grid.seq_group
        B, tl, H, hd = q.shape
        kw = dict(dropout_rate=rate, dropout_seed=seed)
        fwd = _pieces(q.device, flash)[0]
        out = torch.zeros((B, tl, H, hd), dtype=torch.float32,
                          device=q.device)
        lse = torch.full((B * H, tl), float("-inf"), device=q.device)
        k_cur, v_cur = k, v
        for s in range(n):
            if s:
                k_cur, v_cur = ring_shift([k_cur, v_cur], group)
            q_off, k_off = pair_geometry(s, idx, n, tl)
            if not _live(s, q_off, k_off, tl, causal, src_len):
                continue
            o_b, lse_b = fwd(q, k_cur, v_cur, pos_off=(q_off, k_off),
                             **_band(flash, causal, src_len, s, q_off,
                                     k_off), **kw)
            out, lse = _combine(out, lse, o_b, lse_b)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse.contiguous())
        ctx.grid, ctx.causal, ctx.src_len, ctx.flash = (grid, causal,
                                                        src_len, flash)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        grid, causal, src_len = ctx.grid, ctx.causal, ctx.src_len
        n, idx, group = grid.n_seq, grid.seq_rank, grid.seq_group
        tl = q.shape[1]
        _, dq_fn, dkv_fn = _pieces(q.device, ctx.flash)
        g = g.to(q.dtype)
        dsum = FA.row_dot(g, out)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        k_cur, v_cur = k, v
        for s in range(n):
            if s:
                k_cur, v_cur, dk, dv = ring_shift([k_cur, v_cur, dk, dv],
                                                  group)
            q_off, k_off = pair_geometry(s, idx, n, tl)
            if not _live(s, q_off, k_off, tl, causal, src_len):
                continue
            kw = dict(_band(ctx.flash, causal, src_len, s, q_off, k_off),
                      pos_off=(q_off, k_off), **ctx.kw)
            dq += dq_fn(q, k_cur, v_cur, g, lse, dsum, **kw).float()
            dk_c, dv_c = dkv_fn(q, k_cur, v_cur, g, lse, dsum, **kw)
            dk += dk_c.float()
            dv += dv_c.float()
        # n - 1 shifts left each key block's sums one hop short of home.
        dk, dv = ring_shift([dk, dv], group)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None, None)


def ring_attention(q, k, v, grid: Grid, *, causal: bool = True,
                   src_len: int = 0, dropout_rate: float = 0.0,
                   dropout_seed=None):
    """q, k, v: this rank's blocks [B, Tl, H, hd] of [B, n Tl, H, hd]
    (f32 or bf16, one dtype) -> its block of the attention output, in q's
    dtype, in the form the JAX function picks (``flash_ok``).
    ``dropout_seed``: the two seed words (``utils.prng.key_to_seed``),
    needed with a rate."""
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("ring attention dropout needs dropout_seed "
                         "(two seed words)")
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"ring attention needs query and key blocks of "
                         f"one length; got {q.shape[1]} and {k.shape[1]}")
    flash = flash_ok(causal, src_len)
    seed = tuple(dropout_seed) if dropout_rate > 0.0 else None
    return _Ring.apply(q, k, v, grid, bool(causal), int(src_len),
                       float(dropout_rate), seed, flash)
