"""Rows 4 and 26's device body (`rmsnorm_right_flat` and
`rmsnorm_right_grouped`, kernels/flat_pipeline.py and grouped_mlp.py,
csrc/flat_pipeline.cu `rmsnorm_right`), on the CPU.

The body computes y^T = R^T xn^T on wgmma m64n16k16 bf16: tiles of 16
token rows (rows past T are zeros), each shared by a cluster of 2 CTAs
that take half of the column groups each; R^T as the register A of
two warpgroups (64 output channels each), read with ldmatrix .trans from
R staged with its 16-byte chunks swizzled by row; xn staged as wgmma's
K-major B with the 128-byte swizzle, float32 sums k-step by k-step (16
columns each), the bf16 outputs through a staging tile whose 16-byte
chunks are swizzled by row. Its sum of squares: each CTA's lanes run over
16-byte chunks of its columns (fl(ss + fl(v * v)) in order), the warp's
butterfly, then the cluster's partial sums added in rank order.

A torch emulation of that body, through the same index functions, must:
  - equal the plain version bit for bit with identity factors when it
    takes the plain version's sum of squares (every y is one exact
    product), and stay within kernels/tolerance.py's "identity" mode
    (one bf16 ulp) with the kernel's order of the sum of squares;
  - stay within the "orthogonal" mode of the plain version and of JAX's
    `rmsnorm_right_flat` / `rmsnorm_right_grouped` (their Pallas kernels
    in interpret mode) with random orthogonal factors;
  - give the grouped layout the flat layout's values bit for bit.

The CUDA body itself is held to the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py (phases 3d, 3j, 5, 6 and 12).
"""

import functools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from flatquant_tpu.kernels import flat_pipeline as jfp
from flatquant_tpu.kernels import grouped_mlp as jgm
from flatquant_torch.kernels import flat_pipeline as tfp
from flatquant_torch.kernels import grouped_mlp as tgm
from flatquant_torch.kernels.tolerance import compare_bf16

torch.set_num_threads(2)

CL = 2  # CTAs of a cluster (csrc RN_CL)
ROWS = 8 * CL  # tokens a tile: wgmma's N (RN_ROWS)
GPS = 2  # column groups a step (RN_GPS)
TILE = ROWS * 256  # bytes of one [ROWS][128] bf16 tile
EPS = 1e-5


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _factor(rng, kind):
    if kind == "identity":
        return np.eye(128, dtype=np.float32)
    qm, r = np.linalg.qr(rng.standard_normal((128, 128)))
    return (qm * np.sign(np.diag(r))).astype(np.float32)


# ---------------------------------------------------------------------------
# the body's index functions (csrc/flat_pipeline.cu rmsnorm_right)
# ---------------------------------------------------------------------------


def glo(g, k):
    """First column group of cluster rank k (rn_glo)."""
    return k * g // CL


def b_offset(gi, r, j):
    """Byte of the xn tiles where the body stores 16-byte chunk j (columns
    8 j .. 8 j + 7) of row r of the step's group gi."""
    return gi * TILE + (j >> 3) * (TILE // 2) + r * 128 + (
        ((j & 7) ^ (r & 7)) << 4)


def sw128_offset(base, r, byte):
    """The byte that wgmma's 128-byte-swizzle K-major descriptor at `base`
    (1024-aligned; 8-row atoms 1024 bytes apart) reads for byte `byte` of
    row r: the 16-byte chunk index XOR the row within its atom."""
    return base + r * 128 + (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15)


def kstep_base(gi, s):
    """Start of k-step s's B operand in group gi's tile (the descriptor's
    address before the swizzle: half s / 4, 32 bytes a k-step in it)."""
    return gi * TILE + (s >> 2) * (TILE // 2), (s & 3) * 32


def o_offset(gi, r, c):
    """Byte of the staging tiles where the body writes output channel c of
    token row r of group gi (2-byte values)."""
    return gi * TILE + r * 256 + (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2


def o_chunk(gi, r, n):
    """Byte of the staging tiles where the body reads 16-byte chunk n of
    row r to store it."""
    return gi * TILE + r * 256 + ((n ^ (r & 7)) << 4)


def r_chunk(d, j):
    """Byte of the staged factor where the body puts 16-byte chunk j
    (columns 8 j .. 8 j + 7) of R's row d."""
    return d * 256 + ((j ^ (d & 7)) << 4)


def ldmatrix_rows(wg, wi, lane, s):
    """(row d of R, chunk j) whose staged bytes lane `lane` of warp wi of
    warpgroup wg addresses for k-step s's ldmatrix .x4 .trans: row lane %
    8 of matrix lane / 8."""
    d = 16 * s + ((lane >> 4) << 3) + (lane & 7)
    return d, ((wg * 64 + wi * 16) >> 3) + ((lane >> 3) & 1)


def ldmatrix_x4_trans(mats):
    """ldmatrix .x4 .trans on four 8 x 8 matrices of 16-bit values (each
    [8 rows][8], as the lanes' row addresses read them): lane t receives
    from matrix i the pair (m[2 (t % 4)][t / 4], m[2 (t % 4) + 1][t / 4])."""
    return [[(m[2 * (t % 4)][t // 4], m[2 * (t % 4) + 1][t // 4])
             for m in mats] for t in range(32)]


def a_fragment(wg, wi, g8, tq, s):
    """(row of R^T, column of R^T) of the four bf16 pairs ra[s][0..3] a
    thread holds: lane (g8, tq) of warp wi of warpgroup wg, k-step s; each
    pair is (row, col) and (row, col + 1)."""
    c = wg * 64 + wi * 16 + g8
    d0, d1 = 16 * s + 2 * tq, 16 * s + 8 + 2 * tq
    return [(c, d0), (c + 8, d0), (c, d1), (c + 8, d1)]


def acc_fragment(wg, wi, g8, tq, e):
    """(output channel, token row of the tile) of accumulator e (0 to
    ROWS / 2 - 1) of lane (g8, tq) of warp wi of warpgroup wg (wgmma
    m64nROWS's D)."""
    return (wg * 64 + wi * 16 + g8 + ((e >> 1) & 1) * 8,
            8 * (e >> 2) + 2 * tq + (e & 1))


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------


def _lane_sum(xf, esize):
    """A warp's sum of squares of each row [T, n]: lane l sums fl(v * v)
    over the 16-byte chunks l, l + 32, ... in order, then the butterfly
    over 16, 8, 4, 2, 1."""
    t, n = xf.shape
    per = 16 // esize  # values a chunk
    rounds = -(-(n // per) // 32)
    pad = torch.zeros((t, rounds * 32 * per), dtype=torch.float32)
    pad[:, :n] = xf  # missing chunks add exact zeros
    v = pad.reshape(t, rounds, 32, per)
    ss = torch.zeros((t, 32), dtype=torch.float32)
    for i in range(rounds):
        for e in range(per):
            ss = ss + v[:, i, :, e] * v[:, i, :, e]
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        ss = ss + ss[:, lanes ^ o]
    return ss[:, :1]


def inv_rms_kernel_order(xf, h, esize):
    """1/rms of each row [T, H] float32 in the body's order: each cluster
    rank's partial over its columns, added in rank order; rsqrt(ss *
    fl(1/H) + eps)."""
    g = h // 128
    ss = None
    for k in range(CL):
        part = _lane_sum(xf[:, glo(g, k) * 128:glo(g, k + 1) * 128], esize)
        ss = part if ss is None else ss + part
    inv_h = torch.tensor(1.0, dtype=torch.float32) / h
    return torch.rsqrt(ss * inv_h + EPS)


@functools.lru_cache(maxsize=None)
def _maps():
    """Index tensors of one group's tiles, from the functions above:
    where the body stores byte b of xn row r, where each k-step's
    descriptor reads it, where accumulator (c, r) goes in the staging
    tile, and where the 16-byte stores read row r's bytes."""
    store = torch.tensor([[b_offset(0, r, b >> 4) + (b & 15)
                           for b in range(256)] for r in range(ROWS)])

    def read(r, b):  # byte b of row r of B, k-step b // 32
        base, k0 = kstep_base(0, b // 32)
        return sw128_offset(base, r, k0 + b % 32)

    reads = torch.tensor([[read(r, b) for b in range(256)]
                          for r in range(ROWS)])
    frag = [acc_fragment(wg, wi, lane >> 2, lane & 3, e)
            for wg in range(2) for wi in range(4) for lane in range(32)
            for e in range(ROWS // 2)]
    cs = torch.tensor([c for c, _ in frag])
    rs = torch.tensor([r for _, r in frag])
    stage = torch.tensor([o_offset(0, r, c) for c, r in frag])
    out = torch.tensor([[o_chunk(0, r, b >> 4) + (b & 15)
                         for b in range(256)] for r in range(ROWS)])
    return store, reads, cs, rs, stage, out


def emulate_body(x, w, right, grouped, ss_order="kernel"):
    """The body on x [T, H] (bf16 or float32): y bf16 [T, H], or
    [H/128, T, 128] when grouped, through the tile walk, the clusters'
    column split and the index functions above."""
    t, h = x.shape
    g = h // 128
    xf = x.to(torch.float32)
    if ss_order == "kernel":
        inv = inv_rms_kernel_order(xf, h, x.element_size())
    else:  # the plain version's
        inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + EPS)
    xn = ((xf * inv) * w.to(torch.float32)).to(torch.bfloat16)
    rt = right.to(torch.bfloat16).float().t()  # R^T [c][d], A
    store, reads, cs, rs, stage_at, out_at = _maps()
    out = torch.zeros(t * h, dtype=torch.bfloat16)
    ov = out.view(g, t, 128) if grouped else out.view(t, g, 128).transpose(
        0, 1)  # [G][T][128] view of the output buffer
    for t0 in range(0, t, ROWS):
        nr = min(ROWS, t - t0)
        tile = torch.zeros((ROWS, g, 128), dtype=torch.bfloat16)
        tile[:nr] = xn[t0:t0 + nr].reshape(nr, g, 128)
        for k in range(CL):  # the cluster's CTAs
            for g0 in range(glo(g, k), glo(g, k + 1), GPS):
                ng = min(GPS, glo(g, k + 1) - g0)
                # xn stored into the step's B tiles, read back k-step by
                # k-step as the descriptors address them
                buf = torch.zeros((ng, TILE), dtype=torch.uint8)
                src = tile[:, g0:g0 + ng].transpose(0, 1).contiguous()
                buf[:, store.flatten()] = src.view(torch.uint8).reshape(
                    ng, -1)
                b = buf[:, reads.flatten()].reshape(ng, ROWS, 256).view(
                    torch.bfloat16).float()  # [ng][ROWS][128]
                # float32 sums k-step by k-step: D[c][r] += A_s B_s^T
                acc = torch.zeros((ng, 128, ROWS), dtype=torch.float32)
                for s in range(8):
                    ks = slice(16 * s, 16 * s + 16)
                    acc = acc + rt[:, ks] @ b[:, :, ks].transpose(1, 2)
                y = acc.to(torch.bfloat16)
                # accumulators -> staging tiles -> the 16-byte stores
                stage = torch.zeros((ng, TILE), dtype=torch.uint8)
                yb = y[:, cs, rs].contiguous().view(torch.uint8).reshape(
                    ng, -1, 2)
                stage[:, stage_at] = yb[:, :, 0]
                stage[:, stage_at + 1] = yb[:, :, 1]
                rows = stage[:, out_at.flatten()].reshape(
                    ng, ROWS, 256).view(torch.bfloat16)
                ov[g0:g0 + ng, t0:t0 + nr] = rows[:, :nr]
    return out.view(g, t, 128) if grouped else out.view(t, h)


def _inputs(rng, t, h, dtype):
    x = jnp.asarray(rng.standard_normal((t, h)) * 2.0, dtype)
    x = x.at[t // 2].set(0.0)  # an all-zero row: y 0
    w = jnp.asarray(rng.uniform(0.5, 1.5, (h,)), jnp.float32)
    return x, w


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t,h", [(1, 256), (40, 128), (40, 640),
                                 (300, 1024)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", ["identity", "orthogonal"])
def test_body_matches_plain_and_jax(rng, t, h, dtype, kind):
    """The emulated body against the plain version and JAX's interpret
    kernel: identity factors within the "identity" mode (one bf16 ulp: the
    kernel's order of the sum of squares may move 1/rms by a float32 ulp,
    and xn by a bf16 ulp), orthogonal ones within the "orthogonal" mode
    (kernels/tolerance.py)."""
    x, w = _inputs(rng, t, h, dtype)
    right = jnp.asarray(_factor(rng, kind), jnp.float32)
    got = emulate_body(_t(x), _t(w), _t(right), grouped=False)
    assert got.shape == (t, h) and got.dtype == torch.bfloat16
    assert not got[t // 2].float().any()
    plain = tfp.rmsnorm_right_flat_ref(_t(x), _t(w), _t(right), EPS)
    compare_bf16(got, plain, kind, "body vs plain")
    want = jfp.rmsnorm_right_flat(x, w, right, EPS, interpret=True)
    compare_bf16(got, _t(want), "orthogonal", "body vs JAX")


@pytest.mark.parametrize("t,h", [(1, 128), (40, 384), (300, 256),
                                 (33, 1152)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_identity_factor_is_bit_exact(rng, t, h, dtype):
    """With identity factors every y is one exact product, whatever the
    order of the tensor cores' sums: taking the plain version's sum of
    squares, the emulated body equals the plain version bit for bit (every
    column group lands once, through whichever CTA of the cluster)."""
    x, w = _inputs(rng, t, h, dtype)
    right = torch.eye(128)
    got = emulate_body(_t(x), _t(w), right, grouped=False, ss_order="plain")
    assert torch.equal(got, tfp.rmsnorm_right_flat_ref(_t(x), _t(w), right,
                                                       EPS))


@pytest.mark.parametrize("t,h", [(40, 640), (9, 512)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_grouped_body_equals_flat_and_matches_jax(rng, t, h, dtype):
    """GROUPED changes only the store addresses: the grouped emulation is
    group_layout of the flat one, bit for bit, and within the "orthogonal"
    mode of JAX's rmsnorm_right_grouped."""
    x, w = _inputs(rng, t, h, dtype)
    right = jnp.asarray(_factor(rng, "orthogonal"), jnp.bfloat16)
    flat = emulate_body(_t(x), _t(w), _t(right), grouped=False)
    grouped = emulate_body(_t(x), _t(w), _t(right), grouped=True)
    assert torch.equal(grouped, tgm.group_layout(flat, h // 128))
    want = jgm.rmsnorm_right_grouped(x, w, right, EPS, interpret=True)
    compare_bf16(tgm.ungroup_layout(grouped),
                 tgm.ungroup_layout(_t(want)), "orthogonal",
                 "grouped body vs JAX")


@pytest.mark.parametrize("g", [1, 2, 3, 5, 32, 86])
def test_cluster_ranks_split_the_groups(g):
    """The cluster's ranks cover the column groups [0, G) once, in order,
    each at most ceil(G / CL) (the staged shared memory's size)."""
    spans = [range(glo(g, k), glo(g, k + 1)) for k in range(CL)]
    assert [i for s in spans for i in s] == list(range(g))
    assert max(len(s) for s in spans) == -(-g // CL)


def test_xn_tile_reads_back_through_the_descriptor(rng):
    """Chunks stored at b_offset come back, through the 128-byte-swizzle
    K-major read of each k-step, as the plain [ROWS][128] tile of every
    group; the groups' tiles do not overlap."""
    tiles = torch.from_numpy(rng.integers(-2**15, 2**15, (GPS, ROWS, 128),
                                          dtype=np.int16))
    buf = torch.zeros(GPS * TILE, dtype=torch.uint8)
    seen = set()
    for gi in range(GPS):
        for r in range(ROWS):
            for j in range(16):
                o = b_offset(gi, r, j)
                assert o % 16 == 0 and o not in seen
                seen.add(o)
                buf[o:o + 16] = tiles[gi, r, 8 * j:8 * j + 8].view(
                    torch.uint8)
    assert len(seen) * 16 == buf.numel()
    for gi in range(GPS):
        for s in range(8):
            base, k0 = kstep_base(gi, s)
            assert base % 1024 == 0
            for r in range(ROWS):
                got = torch.stack([buf[sw128_offset(base, r, k0 + k)]
                                   for k in range(32)]).view(torch.int16)
                assert torch.equal(got, tiles[gi, r, 16 * s:16 * s + 16])


def test_staging_tile_is_a_permutation():
    """Each (row, channel) of a staging tile has its own two bytes, the
    16-byte chunks read back hold channels 8 n .. 8 n + 7 of their row in
    order, and a warp's 2-byte writes of one accumulator never put two
    different 4-byte words in one bank (no bank conflict)."""
    owner = {}
    for r in range(ROWS):
        for c in range(128):
            o = o_offset(0, r, c)
            assert o not in owner
            owner[o] = (r, c)
    for r in range(ROWS):
        for n in range(16):
            o = o_chunk(0, r, n)
            assert [owner[o + 2 * k] for k in range(8)] == [
                (r, 8 * n + k) for k in range(8)]
    for wi in range(4):
        for e in range(ROWS // 2):
            banks = {}
            for lane in range(32):
                c, r = acc_fragment(0, wi, lane >> 2, lane & 3, e)
                word = o_offset(0, r, c) // 4
                banks.setdefault(word % 32, set()).add(word)
            assert all(len(words) == 1 for words in banks.values())


def test_fragments_cover_the_product():
    """The register A fragments of the two warpgroups hold every element
    of R^T exactly once, and the accumulators every (channel, token row)
    of the [128][ROWS] output exactly once."""
    a_seen, d_seen = {}, {}
    for wg in range(2):
        for wi in range(4):
            for lane in range(32):
                g8, tq = lane >> 2, lane & 3
                for s in range(8):
                    for (c, d) in a_fragment(wg, wi, g8, tq, s):
                        for k in (d, d + 1):
                            assert (c, k) not in a_seen
                            a_seen[c, k] = (wg, wi, lane, s)
                for e in range(ROWS // 2):
                    cr = acc_fragment(wg, wi, g8, tq, e)
                    assert cr not in d_seen
                    d_seen[cr] = (wg, wi, lane, e)
    assert len(a_seen) == 128 * 128 and len(d_seen) == 128 * ROWS


def test_ldmatrix_gives_the_a_fragments(rng):
    """R staged with its 16-byte chunks swizzled by row (r_chunk), read by
    each warp's ldmatrix .x4 .trans at ldmatrix_rows, gives every lane the
    pairs of R^T that a_fragment names; the 8 rows of each matrix lie in
    8 distinct 16-byte bank groups (no conflict)."""
    r = torch.from_numpy(rng.integers(-2**15, 2**15, (128, 128),
                                      dtype=np.int16))
    staged = torch.zeros(128 * 256, dtype=torch.uint8)
    for d in range(128):
        for j in range(16):
            o = r_chunk(d, j)
            staged[o:o + 16] = r[d, 8 * j:8 * j + 8].view(torch.uint8)
    vals = staged.view(torch.int16)  # 2-byte values, by byte offset / 2
    for wg in range(2):
        for wi in range(4):
            for s in range(8):
                mats = []
                for i in range(4):
                    rows, banks = [], set()
                    for lane in range(8 * i, 8 * i + 8):
                        o = r_chunk(*ldmatrix_rows(wg, wi, lane, s))
                        rows.append(vals[o // 2:o // 2 + 8].tolist())
                        banks.add((o % 128) // 16)
                    mats.append(rows)
                    assert len(banks) == 8
                got = ldmatrix_x4_trans(mats)
                for lane in range(32):
                    want = a_fragment(wg, wi, lane >> 2, lane & 3, s)
                    for q, (c, d) in enumerate(want):
                        assert got[lane][q] == (r[d, c].item(),
                                                r[d + 1, c].item())


@pytest.mark.parametrize("h,dtype", [(128, torch.bfloat16),
                                     (4096, torch.bfloat16),
                                     (640, torch.float32),
                                     (4096, torch.float32)])
def test_sum_of_squares_order(rng, h, dtype):
    """The body's order of the sum of squares (each rank's lanes over
    16-byte chunks of its columns, the butterfly, the ranks in order)
    lands within 2 float32 ulps of 1/rms of the plain version's
    torch.mean."""
    x = torch.from_numpy(rng.standard_normal((64, h)).astype(
        np.float32) * 3).to(dtype)
    xf = x.float()
    got = inv_rms_kernel_order(xf, h, x.element_size())
    want = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + EPS)
    ulp = torch.finfo(torch.float32).eps * want.abs()
    assert ((got - want).abs() <= 2 * ulp).all()
