"""The nibble kernels of sea_tpu_torch/csrc/quant_bench.cu replayed on the
CPU in numpy, instruction by instruction, with the constants read from the
CUDA source: the tensor-core matvecs p4_mma<kP4>, p4_mma<kP4b> and
p4_mma<kP4c> (matvec_p4, matvec_p4b, matvec_p4c) and the word-wise sums of
unpack_sums (_unpack_only_call). No JAX: the plain versions in
sea_tpu_torch/tools/ are the reference, and they match the JAX tools in
tests/test_torch_tools_quant.py.

- The unpack of one MMA (a byte permute, prmt's sign-replicating selectors,
  lop3 as its boolean function, shifts, the funnel shift, a 32-bit add,
  bf16 bit patterns, the bf16x2 subtraction) over every byte value in every
  byte position of both rows' words, bit for bit equal to the plain
  versions' planes: kP4's ((w & 0xF) ^ 8) - 8 and ((w >> 4) ^ 8) - 8,
  kP4b's int8(w << 4) >> 4 and int8(w) >> 4, kP4c's (w & 0xF) ^ 8 and
  int8(w) & -16; each also against the plain function itself on one-hot
  rows of x.
- One call's m16n8k16 fragments (lane -> column and k, the B fragment of x
  and x's high half / 16, the accumulator -> output map, the warps' split
  of K/2, f32 sums in the kernel's order, kP4c's rank-1 term), at a shape
  with a k tail shorter than one MMA step and a last column tile cut by N,
  within 1e-5 x sum|x w s| of the plain version; a wrong column map fails
  that check.
- unpack_sums' two sums of a word (lop3, AND, dp4a unsigned and signed)
  over every byte value in every byte position and 10^5 random words,
  equal to the per-byte sums of unpack_only_parts_ref; and its partition,
  computed as its launcher computes the grid: every byte of every tile
  read once, the last tile by the blocks whose words the result adds,
  every element of x added once into a slot the wrapper's scratch holds.
"""

import os
import re

import numpy as np
import pytest
import torch

from sea_tpu_torch.tools import bench_quant_matvec as PQ
from sea_tpu_torch.tools import bench_unpack_ceiling as PU

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "sea_tpu_torch", "csrc", "quant_bench.cu")
RTOL = 1e-5
M32 = np.uint64(0xFFFFFFFF)


def _constants():
    """{name: int or [int]} of the `constexpr uint32_t k...` lines."""
    text = open(SOURCE).read()
    out = {}
    for name, body in re.findall(
            r"constexpr uint32_t (k\w+)(?:\[\d+\])? = ([^;]+);", text):
        vals = [int(v.rstrip("u"), 0)
                for v in re.findall(r"0x[0-9A-Fa-f]+u|\b\d+u", body)]
        out[name] = vals if body.strip().startswith("{") else vals[0]
    for name in ("kS8Warps", "kS8Cols", "kS8StepRows", "kMaxB", "kThreads",
                 "kUnpackRows", "kXPerThread"):
        out[name] = int(re.search(rf"constexpr int {name} = (\d+);",
                                  text).group(1))
    return out


C = _constants()


# ---------------------------------------------------------------------------
# The instructions
# ---------------------------------------------------------------------------

def u32(a):
    return np.asarray(a, dtype=np.uint64) & M32


def prmt(a, b, sel):
    """prmt.b32 d, a, b, sel in the default mode: byte n of d is byte
    (nibble n of sel) & 7 of b:a, or, where the nibble's bit 3 is set, that
    byte's sign bit copied into all 8 bits."""
    src = (u32(b) << np.uint64(32)) | u32(a)
    out = np.zeros_like(src)
    for n in range(4):
        nib = (sel >> (4 * n)) & 0xF
        byte = (src >> np.uint64(8 * (nib & 7))) & np.uint64(0xFF)
        if nib & 8:
            byte = np.where(byte & np.uint64(0x80), np.uint64(0xFF),
                            np.uint64(0))
        out |= byte << np.uint64(8 * n)
    return out


def lop3(a, b, c, lut):
    """lop3.b32: bit i of d is bit (a_i << 2 | b_i << 1 | c_i) of lut."""
    a, b, c = u32(a), u32(b), u32(c)
    out = np.zeros_like(a)
    for i in range(8):
        if lut >> i & 1:
            out |= ((a if i & 4 else ~a) & (b if i & 2 else ~b)
                    & (c if i & 1 else ~c))
    return out & M32


def shr(a, n):
    return u32(a) >> np.uint64(n)


def shl(a, n):
    return (u32(a) << np.uint64(n)) & M32


def funnel_r(lo, hi, n):
    """shf.r: the low 32 bits of (hi : lo) >> n."""
    return (((u32(hi) << np.uint64(32)) | u32(lo)) >> np.uint64(n)) & M32


def add3(a, b, c):
    return (u32(a) + u32(b) + u32(c)) & M32


def bf16_f32(bits):
    """bf16 bit patterns (low 16 bits) as f32."""
    return ((u32(bits) & np.uint64(0xFFFF)) << np.uint64(16)).astype(
        np.uint32).view(np.float32)


def f32_bf16(f):
    """f32 -> bf16 bits, round to nearest even."""
    b = np.asarray(f, np.float32).view(np.uint32).astype(np.uint64)
    return ((b + ((b >> np.uint64(16)) & np.uint64(1)) + np.uint64(0x7FFF))
            >> np.uint64(16)) & np.uint64(0xFFFF)


def halves(r):
    """bf16x2 -> (low half, high half) as f32."""
    return bf16_f32(r), bf16_f32(shr(r, 16))


def bf16x2(op, a, b):
    """A bf16x2 operation: each half in f32, rounded to bf16."""
    (a0, a1), (b0, b1) = halves(a), halves(b)
    return f32_bf16(op(a0, b0)) | (f32_bf16(op(a1, b1)) << np.uint64(16))


def hsub2(a, b):
    return bf16x2(np.subtract, a, b)


def hmul2(a, b):
    return bf16x2(np.multiply, a, b)


LUT_AND_XOR = 0x6A  # (a & b) ^ c, the kernel's and_xor


# ---------------------------------------------------------------------------
# The unpack of one MMA: words ra (row r, low half of each A register) and
# rb (row r + 1, high half), tile h of word q -> (a0, a1, a2, a3)
# ---------------------------------------------------------------------------

def sext_pair(i, lo_src, hi_src):
    """p4_mma's sext_pair<i>."""
    s = add3(prmt(lo_src, 0, C["kP4bSext"][i]),
             prmt(hi_src, 0, C["kP4bHigh"][i]), C["kP4bBias"])
    return hsub2(funnel_r(s, C["kP4bCarry"], 4), C["kBf16x2_136"])


def p4b_regs(ra, rb, h):
    la = shl(ra, 4)
    lb = shl(rb, 4) & np.uint64(C["kNibbleMask"])
    hb = u32(rb) & np.uint64(C["kNibbleMask"])
    c0, c1 = 2 * h, 2 * h + 1
    return (sext_pair(c0, la, lb), sext_pair(c1, la, lb),
            sext_pair(c0, ra, hb), sext_pair(c1, ra, hb))


def nibbles_to_bf16x2(u):
    """The nibbles at bits 0-3 and 16-19 of u as bf16x2 (n ^ 8) - 8."""
    return hsub2(lop3(u, C["kNibMask"], C["kNibXor"], LUT_AND_XOR),
                 C["kBf16x2_136"])


def p4_regs(ra, rb, h):
    v = prmt(ra, rb, C["kP4Gather"][h])
    return (nibbles_to_bf16x2(v), nibbles_to_bf16x2(shr(v, 8)),
            nibbles_to_bf16x2(shr(v, 4)), nibbles_to_bf16x2(shr(v, 12)))


def p4c_regs(ra, rb, h):
    v = prmt(ra, rb, C["kP4Gather"][h])

    def lo(u):
        return hsub2(lop3(u, C["kNibMask"], C["kNibXor"], LUT_AND_XOR),
                     C["kP4cLoSub"])

    def hi(u):
        return hsub2(lop3(u, C["kP4cHiMask"], C["kP4cHiXor"], LUT_AND_XOR),
                     C["kP4cHiXor"])

    return lo(v), lo(shr(v, 8)), hi(shr(v, 1)), hi(shr(v, 9))


REGS = {"matvec_p4": p4_regs, "matvec_p4b": p4b_regs,
        "matvec_p4c": p4c_regs}


def _planes(name, byte):
    """The plain version's two planes of packed bytes (uint8 numpy), as
    bf16 bit patterns, computed as matvec_p4_ref, matvec_p4b_ref and
    matvec_p4c_ref do."""
    w8 = torch.from_numpy(np.asarray(byte, np.uint8)).view(torch.int8)
    if name == "matvec_p4":
        w = torch.from_numpy(np.asarray(byte, np.uint8)).to(torch.int32)
        lo, hi = ((w & 0xF) ^ 8) - 8, ((w >> 4) ^ 8) - 8
    elif name == "matvec_p4b":
        lo, hi = (w8 << 4) >> 4, w8 >> 4
    else:
        lo, hi = (w8 & 0xF) ^ 8, w8 & -16
    return tuple(p.to(torch.bfloat16).view(torch.int16).numpy().astype(
        np.uint16).astype(np.uint64) for p in (lo, hi))


def _every_byte_words(seed):
    """Word pairs (ra, rb) in which every byte value stands in every byte
    position of ra and of rb, the other bytes random."""
    rs = np.random.RandomState(seed)
    vals = np.arange(256, dtype=np.uint64)
    ra, rb = [], []
    for pos in range(4):
        for mine, other in ((ra, rb), (rb, ra)):
            words = rs.randint(0, 2 ** 32, size=256).astype(np.uint64)
            shift = np.uint64(8 * pos)
            mine.append((words & ~(np.uint64(0xFF) << shift) & M32)
                        | (vals << shift))
            other.append(rs.randint(0, 2 ** 32, size=256).astype(np.uint64))
    return np.concatenate(ra), np.concatenate(rb)


def _check_unpack(name):
    ra, rb = _every_byte_words(seed=len(name))
    for h in (0, 1):
        a0, a1, a2, a3 = REGS[name](ra, rb, h)
        for col, (reg_lo, reg_hi) in ((2 * h, (a0, a2)),
                                      (2 * h + 1, (a1, a3))):
            for row, half in ((ra, 0), (rb, 16)):
                byte = (shr(row, 8 * col) & np.uint64(0xFF)).astype(np.uint8)
                want_lo, want_hi = _planes(name, byte)
                got_lo = shr(reg_lo, half) & np.uint64(0xFFFF)
                got_hi = shr(reg_hi, half) & np.uint64(0xFFFF)
                np.testing.assert_array_equal(got_lo, want_lo,
                                              err_msg=f"{name} lo h={h}")
                np.testing.assert_array_equal(got_hi, want_hi,
                                              err_msg=f"{name} hi h={h}")


def _one_hot_planes(name):
    """The plain function on x = the identity over all 256 bytes (K/2 =
    256, one byte value a row): its rows are the weights it multiplies,
    (lo, hi) for kP4 and kP4b, (lo + 8 - 8, 16 hi / 16) for kP4c."""
    wp = torch.arange(256, dtype=torch.uint8).reshape(256, 1).repeat(1, 16)
    x = torch.eye(512, dtype=torch.bfloat16)
    y = getattr(PQ, name + "_ref")(x, wp, torch.ones(1, 16), block_n=16)
    return y[:256, 0].numpy(), y[256:, 0].numpy()


def test_p4_unpack_is_the_32bit_form():
    """kP4's A registers are the plain planes ((w & 0xF) ^ 8) - 8 and
    ((w >> 4) ^ 8) - 8 bit for bit: mvt_mma's lop3 (the same constants as
    kP4c's lo plane) and one subtraction of 136, with neither kP4c's 1/16
    nor its rank-1 term."""
    assert C["kNibXor"] == C["kBf16x2_136"]  # 128 + 8 in each bf16 half
    _check_unpack("matvec_p4")
    lo, hi = _one_hot_planes("matvec_p4")
    want = _planes("matvec_p4", np.arange(256, dtype=np.uint8))
    np.testing.assert_array_equal(lo, bf16_f32(want[0]))
    np.testing.assert_array_equal(hi, bf16_f32(want[1]))


def test_p4b_unpack_is_byte_width_sign_extension():
    """kP4b's A registers are the plain planes int8(w << 4) >> 4 and
    int8(w) >> 4 bit for bit, through sign-replicating byte permutes and an
    arithmetic (funnel) shift, never the XOR-8 bias of matvec_p4."""
    for sel in C["kP4bSext"]:  # bytes 1-3 replicate byte 0's sign
        assert all((sel >> (4 * n)) & 8 for n in (1, 2, 3)), hex(sel)
    for sel in C["kP4bHigh"]:  # byte 3 replicates byte 2's sign
        assert (sel >> 12) & 8 and not (sel >> 8) & 8, hex(sel)
    _check_unpack("matvec_p4b")
    lo, hi = _one_hot_planes("matvec_p4b")
    want = _planes("matvec_p4b", np.arange(256, dtype=np.uint8))
    np.testing.assert_array_equal(lo, bf16_f32(want[0]))
    np.testing.assert_array_equal(hi, bf16_f32(want[1]))


def test_p4c_unpack_is_the_bias_form():
    """kP4c's A registers are the plain planes (w & 0xF) ^ 8 = lo + 8 and
    int8(w) & -16 = 16 hi bit for bit; with x's high half / 16 and 8
    sum(x_lo) taken off they are the weights lo and hi."""
    _check_unpack("matvec_p4c")
    lo, hi = _one_hot_planes("matvec_p4c")
    lo8, hi16 = (bf16_f32(p) for p in _planes(
        "matvec_p4c", np.arange(256, dtype=np.uint8)))
    np.testing.assert_array_equal(lo, lo8 - 8)
    np.testing.assert_array_equal(hi, hi16 / 16)
    # 1/16 in bf16 scales a bf16 pair exactly
    x = f32_bf16(np.float32(-3.140625)) | (f32_bf16(np.float32(0.5))
                                          << np.uint64(16))
    np.testing.assert_array_equal(halves(hmul2(x, C["kBf16x2_1_16"])),
                                  (np.float32(-3.140625 / 16),
                                   np.float32(0.5 / 16)))


# ---------------------------------------------------------------------------
# One call's fragments
# ---------------------------------------------------------------------------

def _column(j, g, hi):
    """p4_mma's accumulator -> column map (warp_sums_out's col lambda)."""
    return 16 * g + 2 * j + hi


def emulate(name, x, wp, s, column=_column):
    """y f32 [B, N] of p4_mma<F> on x bf16 [B, K], wp uint8 [K/2, N], s f32
    [1, N]: every block's lanes, steps and MMAs, f32 sums in its order."""
    warps, cols, step_rows = C["kS8Warps"], C["kS8Cols"], C["kS8StepRows"]
    B, K = x.shape
    K2, N = wp.shape
    blocks, steps = -(-N // cols), -(-K2 // step_rows)
    # Loads past K/2 or N read zeros: pad to whole steps and tiles.
    wpad = np.zeros((steps * step_rows, blocks * cols), np.uint8)
    wpad[:K2, :N] = wp.numpy()
    words = wpad.view("<u4").astype(np.uint64)  # [row, column / 4]
    xb = x.view(torch.int16).numpy().astype(np.uint16).astype(np.uint64)
    xl = np.zeros((8, steps * step_rows), np.uint64)
    xh = np.zeros_like(xl)
    xl[:B, :K2], xh[:B, :K2] = xb[:, :K2], xb[:, K2:]
    g = np.arange(8).reshape(8, 1)
    t = np.arange(4).reshape(1, 4)
    blk = np.arange(blocks).reshape(blocks, 1, 1)
    acc = np.zeros((blocks, warps, 8, 16, 8), np.float32)  # [tile][row][x]
    xsum = np.zeros((warps, 8, 4), np.float32)
    for st in range(steps):
        w = st % warps
        for c in range(2):
            r = step_rows * st + 4 * t + 2 * c  # rows r (k slot 2t), r + 1
            b0 = xl[g, r] | (xl[g, r + 1] << np.uint64(16))
            b1 = xh[g, r] | (xh[g, r + 1] << np.uint64(16))
            if name == "matvec_p4c":
                b1 = hmul2(b1, C["kBf16x2_1_16"])
                for part in halves(b0):
                    xsum[w] = xsum[w] + part
            bm = np.zeros((16, 8))
            for k0, reg in ((0, b0), (8, b1)):
                lo, hi = halves(reg)
                bm[k0 + 2 * t, g] = lo
                bm[k0 + 2 * t + 1, g] = hi
            for q in range(4):
                col4 = (cols * blk + 16 * g) // 4 + q
                ra, rb = words[r, col4], words[r + 1, col4]
                for h in range(2):
                    am = np.zeros((blocks, 16, 16))
                    for (row0, k0), reg in zip(((0, 0), (8, 0), (0, 8),
                                                (8, 8)),
                                               REGS[name](ra, rb, h)):
                        lo, hi = halves(reg)
                        am[:, row0 + g, k0 + 2 * t] = lo
                        am[:, row0 + g, k0 + 2 * t + 1] = hi
                    j = 2 * q + h
                    acc[:, w, j] = (acc[:, w, j] + am @ bm).astype(np.float32)
    total = np.zeros((blocks, 8, 16, 8), np.float32)
    for w in range(warps):
        total = total + acc[:, w]
    if name == "matvec_p4c":  # shuffles: (s0 + s1) + (s2 + s3)
        lanes = ((xsum[..., 0] + xsum[..., 1]) + (xsum[..., 2]
                                                  + xsum[..., 3]))
        corr = np.zeros(8, np.float32)
        for w in range(warps):
            corr = corr + lanes[w]
        total = total - np.float32(8) * corr
    y = np.zeros((B, N), np.float32)
    sv = s.reshape(-1).numpy()
    for b in range(blocks):
        for j in range(8):
            for gg in range(8):
                for hi in range(2):
                    n = cols * b + column(j, gg, hi)
                    if n < N:
                        y[:, n] = total[b, j, gg + 8 * hi, :B] * sv[n]
    return y


def _inputs(K, N, B, seed):
    rs = np.random.RandomState(seed)
    q = torch.from_numpy(rs.randint(-8, 8, size=(K, N)).astype(np.int8))
    x = torch.from_numpy(rs.standard_normal((B, K)).astype(
        np.float32)).to(torch.bfloat16)
    s = torch.from_numpy((rs.rand(1, N) * 0.1 + 0.01).astype(np.float32))
    mag = ((x.float().abs() @ q.float().abs()) * s).numpy()
    return x, PQ.pack_nibbles(q), s, mag


@pytest.mark.parametrize("name", ["matvec_p4", "matvec_p4b",
                                  "matvec_p4c"])
@pytest.mark.parametrize("K,N", [(72, 400), (520, 144)])
def test_block_fragments_match_plain(name, K, N):
    """The emulated call at B = 1, 3 and 8 within 1e-5 x sum|x w s| of the
    plain version: K = 72 has a k tail of 4 packed rows in its last step
    (K/2 = 36) and a last tile of one column group (N = 400); K = 520 has
    17 steps, so warp 0 takes two."""
    for B in (1, 3, 8):
        x, wp, s, mag = _inputs(K, N, B, seed=K + N + B)
        want = getattr(PQ, name + "_ref")(x, wp, s, block_n=16).numpy()
        got = emulate(name, x, wp, s)
        assert np.all(np.abs(got - want) <= RTOL * mag), (name, K, N, B)


def test_wrong_column_map_fails_the_check():
    """The fragment check is not vacuous: the accumulator read through
    mvt_mma's column map (16 j + g + 8 hi) fails it."""
    x, wp, s, mag = _inputs(72, 400, 3, seed=1)
    want = PQ.matvec_p4b_ref(x, wp, s, block_n=16).numpy()
    got = emulate("matvec_p4b", x, wp, s,
                  column=lambda j, g, hi: 16 * j + g + 8 * hi)
    assert not np.all(np.abs(got - want) <= RTOL * mag)


# ---------------------------------------------------------------------------
# unpack_sums (_unpack_only_call): the word-wise sums and the partition
# ---------------------------------------------------------------------------

def dp4a(a, b, signed):
    """dp4a.u32.u32 or dp4a.s32.s32 with c = 0: the sum over the four byte
    lanes of a's byte times b's, each byte unsigned or signed."""
    total = np.zeros(np.shape(a), np.int64)
    for i in range(4):
        pa, pb = ((u32(v) >> np.uint64(8 * i)) & np.uint64(0xFF)
                  for v in (a, b))
        pa, pb = pa.astype(np.int64), pb.astype(np.int64)
        if signed:
            pa, pb = (np.where(p >= 128, p - 256, p) for p in (pa, pb))
        total += pa * pb
    return total


def word_sums(w):
    """unpack_sums' (lo, hi) of 32-bit words w: one lop3 and an unsigned
    dp4a, one AND and a signed dp4a."""
    lo = dp4a(lop3(w, C["kWordLoMask"], C["kWordLoXor"], LUT_AND_XOR),
              C["kOnes"], signed=False)
    hi = dp4a(u32(w) & np.uint64(C["kNibbleMask"]), C["kOnes"], signed=True)
    return lo, hi


def test_unpack_word_sums_match_plain():
    """A word's two sums, as unpack_sums forms them, equal the sums over
    its four bytes of unpack_only_parts_ref's per-byte terms, (w & 0xF) ^
    8 and int8(w) & -16, for every byte value in every byte position and
    for 10^5 random words; the word a row past K/2 reads adds 0 to both."""
    table = np.array([PU.unpack_only_parts_ref(
        torch.zeros(1, 1, dtype=torch.bfloat16),
        torch.tensor([[b]], dtype=torch.uint8), block_n=1)[1].numpy()
        for b in range(256)])  # [byte value, (lo, hi)]
    ra, _ = _every_byte_words(seed=5)
    rs = np.random.RandomState(6)
    words = np.concatenate([ra, rs.randint(0, 2 ** 32, size=10 ** 5)
                            .astype(np.uint64)])
    lo, hi = word_sums(words)
    byte = np.stack([(words >> np.uint64(8 * i)) & np.uint64(0xFF)
                     for i in range(4)], axis=1).astype(np.int64)
    np.testing.assert_array_equal(lo, table[byte, 0].sum(axis=1))
    np.testing.assert_array_equal(hi, table[byte, 1].sum(axis=1))
    for pos in range(4):  # every value in every position
        assert set(byte[512 * pos:512 * pos + 256, pos]) == set(range(256))
    assert word_sums(np.uint64(C["kPadWord"])) == (0, 0)


def unpack_grid(K2, N, block_n):
    """unpack_sums' launcher: (rows a block, row splits, tiles)."""
    rows = C["kThreads"] // (block_n // 16) * C["kUnpackRows"]
    return rows, -(-K2 // rows), N // block_n


@pytest.mark.parametrize("K2,N,block_n", [(1024, 16384, 512),
                                          (1024, 16384, 2048),
                                          (36, 400, 16)])
def test_unpack_partition_counts_every_byte_once(K2, N, block_n):
    """Every 16-byte piece of wp [K2, N] is read by exactly one thread of
    one block (blockIdx (x, y), thread t: tile tiles - 1 - y, column group t
    % groups, rows k0 + t // groups + u lanes); the blocks whose words the
    last block adds are exactly those of the last tile; every element of x
    (xn = 2048, 16384, 37, and more chunks than blocks) is added once, into
    a slot past the blocks' words, and every block holding a chunk arrives
    on the counter. The grid and the scratch's words are the launcher's
    (unpack_layout), from the source's constants."""
    threads, per = C["kThreads"], C["kUnpackRows"]
    rows, splits, tiles = unpack_grid(K2, N, block_n)
    groups = block_n // 16
    lanes = threads // groups
    t = np.arange(threads)
    g, lane = t % groups, t // groups
    count = np.zeros((K2, N // 16), np.int64)
    last_tile_words = set()
    for bx in range(splits):
        k0, k1 = bx * rows, min(K2, bx * rows + rows)
        for by in range(tiles):
            tile = tiles - 1 - by
            if tile == tiles - 1:
                last_tile_words.add(by * splits + bx)
            for u in range(per):
                r = k0 + lane + u * lanes
                keep = (lane < lanes) & (r < k1)
                piece = (tile * block_n + 16 * g)[keep] // 16
                np.add.at(count, (r[keep], piece), 1)
    np.testing.assert_array_equal(count, 1)
    assert last_tile_words == set(range(splits))  # words 0 .. gridDim.x - 1
    blocks = splits * tiles
    chunk = threads * C["kXPerThread"]  # kXChunk
    e = np.arange(C["kXPerThread"])[:, None]
    for xn in (2048, 16384, 37, 2 * blocks * chunk + 5):
        chunks = -(-xn // chunk)
        words = 1 + blocks + chunks
        arrivals = max(splits, min(chunks, blocks))
        assert len(set(range(splits)) | set(range(min(chunks, blocks)))) \
            == arrivals
        seen = np.zeros(xn, np.int64)
        for b in range(blocks):  # block b = blockIdx.y * splits + blockIdx.x
            for c in range(b, chunks, blocks):
                assert b < min(chunks, blocks)  # so it arrives
                assert 1 + blocks + c < words  # past the blocks' words
                i = (c * chunk + e * threads + t).ravel()
                np.add.at(seen, i[i < xn], 1)
        np.testing.assert_array_equal(seen, 1)
