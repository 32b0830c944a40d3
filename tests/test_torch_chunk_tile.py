"""Rows 9 and 11's device body (`chunk_attention_int4` and
`paged_chunk_attention_int4`, kernels/kv_cache.py and kernels/paged_kv.py,
csrc/kv_cache.cu), on the CPU: the tensor-core order, the decoded code
tiles, and the launch glue.

The body runs both products on wgmma bf16 with float32 sums: q split into
bf16 hi + lo (the lo pass skipped when every lo is 0), S = q_hi k^T +
q_lo k^T on the K codes decoded to bf16 (exact), the folded epilogue
(raw - qsum z_k) s_k sm_scale log2 e with each row's causal limit, an
online softmax in the exp2 domain over 128-key tiles, p' = p s_v split into
bf16 hi + lo, and o += p'_hi V + p'_lo V on the V codes; two warpgroups
take a block's tiles in turn and merge their states. A torch emulation
of those rounding points (float32 sums per 128-key tile) must stay within
TOL of the plain version and of the JAX package's
`chunk_attention_int4_v4` (its Pallas kernel in interpret mode, as the JAX
package's own tests run it); the emulation through a block table must
equal the slot cache's bit for bit. The decoded tiles' layout, as the
kernel writes it and as the wgmma descriptors read it, must give the
plain unpack of the codes.

The CUDA body itself is held to the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py (phases 3f and 7).
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from flatquant_tpu.kernels import kv_cache as jkv
from flatquant_torch.kernels import common
from flatquant_torch.kernels import kv_cache as tkv
from flatquant_torch.kernels import paged_kv as tpk

torch.set_num_threads(2)

TS = 128    # keys a tile (csrc/kv_cache.cu TS)
ROWS = 64   # query rows a block (csrc/kv_cache.cu CH_ROWS)
WG = 2      # warpgroups a block, taking the tiles in turn (CH_WG)
SM = 1.0 / math.sqrt(128)
LOG2E = 1.4426950408889634
# float32 outputs of size ~1. p' = p * s_v as two bf16 terms leaves 2^-18
# of p' against codes up to 15 before (acc - z) / l cancels the zero: up
# to ~1e-5 of an output where a row's weight sits on few keys (measured:
# 1.2e-5 at most over the cases here; the plain version and JAX's kernel
# agree to 2.3e-6). q's split leaves less. The card tests hold the kernel
# to 1e-4
TOL = dict(rtol=1e-5, atol=3e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _unpack(codes):
    c = codes.to(torch.int32)
    return torch.cat([c & 0xF, c >> 4], dim=-1).to(torch.float32)


def slot_reader(kp, kparam, vp, vparam):
    def read(b, h, t0):
        sl = slice(t0, t0 + TS)
        return kp[b, h, sl], kparam[b, h, sl], vp[b, h, sl], vparam[b, h, sl]
    return read


def paged_reader(kp, kparam, vp, vparam, tbl):
    bs = kp.shape[2]

    def read(b, h, t0):
        blk = int(tbl[b, t0 // bs])
        sl = slice(t0 % bs, t0 % bs + TS)
        return (kp[blk, h, sl], kparam[blk, h, sl], vp[blk, h, sl],
                vparam[blk, h, sl])
    return read


def emulate_chunk(q, read, nkv, pos, s_eff, sm_scale):
    """The body's order in torch. q [B, Sq, nh, 128]; read(b, h, t0) gives
    a tile's codes and params (keys past s_eff arrive as zeros). Per block
    of ROWS flattened rows (r = rep * Sq + s): the tiles up to the block's
    largest limit, each row masked at its own limit, warpgroup w taking
    tiles w, w + WG, ...; the states merge in the order w = 0, 1, ...
    Returns [B, Sq, nh, 128] float32."""
    B, sq, nh, hd = q.shape
    qr = tkv._chunk_rows(q, nkv)  # [B, nkv, R, 128] float32
    R = qr.shape[2]
    out = torch.zeros_like(qr)
    scale2 = torch.tensor(sm_scale, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    for b in range(B):
        p0 = int(pos[b])
        for h in range(nkv):
            for r0 in range(0, R, ROWS):
                rows = torch.arange(r0, r0 + ROWS)
                x = torch.zeros((ROWS, hd))
                n_in = min(ROWS, R - r0)
                x[:n_in] = qr[b, h, r0:r0 + n_in]
                hi = _bf16(x)
                lo = _bf16(x - hi)
                qsum = x.sum(-1)
                lim = torch.clamp_max(p0 + rows % sq, s_eff - 1)
                s_max = int((rows[:n_in] % sq).max())
                kend = min(p0 + s_max + 1, s_eff)
                state = []  # (m, l, z, acc) of each warpgroup
                for w in range(WG):
                    state.append(_tiles(hi, lo, qsum, lim, read, b, h,
                                        range(w * TS, kend, WG * TS),
                                        scale2))
                m, l, z, acc = state[0]
                for mw, lw, zw, aw in state[1:]:
                    big = torch.maximum(m, mw)
                    a, c = torch.exp2(m - big), torch.exp2(mw - big)
                    l, z = a * l + c * lw, a * z + c * zw
                    acc = a[:, None] * acc + c[:, None] * aw
                    m = big
                o = (acc - z[:, None]) / torch.clamp_min(l, 1e-30)[:, None]
                out[b, h, r0:r0 + n_in] = o[:n_in]
    return tkv._chunk_unrows(out, q.float())


def _tiles(hi, lo, qsum, lim, read, b, h, starts, scale2):
    """One warpgroup's online softmax over the tiles at `starts` (keys past
    the cache arrive as zeros and are masked): its (m, l, z, acc)."""
    rows, hd = hi.shape
    m = torch.full((rows,), -1e30)
    l, z = torch.zeros(rows), torch.zeros(rows)
    acc = torch.zeros((rows, hd))
    for t0 in starts:
        kc, kpr, vc, vpr = read(b, h, t0)
        pad = TS - kc.shape[0]
        ck = _unpack(torch.cat([kc, kc.new_zeros((pad, 64))]))
        cv = _unpack(torch.cat([vc, vc.new_zeros((pad, 64))]))
        kpr = torch.cat([kpr, kpr.new_zeros((pad, 2))])
        vpr = torch.cat([vpr, vpr.new_zeros((pad, 2))])
        raw = hi @ ck.T + lo @ ck.T
        ks2 = kpr[:, 0] * scale2
        sc = (raw - qsum[:, None] * kpr[None, :, 1]) * ks2[None]
        keys = t0 + torch.arange(TS)
        sc = torch.where(keys[None] > lim[:, None], -math.inf, sc)
        m_new = torch.maximum(m, sc.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(sc - m_new[:, None])
        l = l * corr + p.sum(-1)
        pv = p * vpr[None, :, 0]
        z = z * corr + (pv * vpr[None, :, 1]).sum(-1)
        ph = _bf16(pv)
        pl = _bf16(pv - ph)
        acc = acc * corr[:, None] + ph @ cv + pl @ cv
        m = m_new
    return m, l, z, acc


def _case(n_rep, nkv, sq, s, pos, seed):
    """Random codes and params in JAX's v4 layout, q, pos; numpy."""
    rng = np.random.default_rng(seed)
    B = len(pos)
    codes = [rng.integers(0, 256, (B, nkv, 64, s)).astype(np.uint8)
             for _ in range(2)]
    params = [np.stack([rng.uniform(0.01, 0.2, (B, nkv, s)),
                        rng.integers(0, 16, (B, nkv, s))], axis=2)
              .astype(np.float32) for _ in range(2)]
    q = rng.standard_normal((B, sq, nkv * n_rep, 128)).astype(np.float32)
    return q, codes[0], params[0], codes[1], params[1], np.array(pos,
                                                                 np.int32)


def _token_major(codes, params):
    kp, ks, kz = tkv.untranspose_kv(_t(codes), _t(params))
    return kp, torch.cat([ks, kz], -1).contiguous()


# n_rep 1, 4, 7, 8; Sq = 40 puts the rows of one block in several reps
# with different limits
@pytest.mark.parametrize("n_rep,nkv", [(1, 2), (4, 2), (7, 1), (8, 1)])
@pytest.mark.parametrize("bf16_q", [False, True])
def test_tile_order_meets_plain_and_jax(n_rep, nkv, bf16_q):
    sq, s = 40, 512
    q, kc, kpr, vc, vpr, pos = _case(n_rep, nkv, sq, s, [0, 300, s - sq],
                                     n_rep)
    if bf16_q:  # the batcher's queries: the lo pass adds exactly 0
        q = _bf16(torch.from_numpy(q)).numpy()
    want = jkv.chunk_attention_int4_v4(jnp.asarray(q), kc, kpr, vc, vpr,
                                       jnp.asarray(pos), SM, interpret=True)
    kp, kparam = _token_major(kc, kpr)
    vp, vparam = _token_major(vc, vpr)
    got = emulate_chunk(_t(q), slot_reader(kp, kparam, vp, vparam), nkv,
                        pos, s, SM)
    plain = tkv.chunk_attention_int4(_t(q), kp, kparam, vp, vparam,
                                     _t(pos), SM)
    torch.testing.assert_close(got, plain, **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_tile_order_at_a_ragged_cache_end():
    """S = 500 (the last tile's keys past it land as zeros and are
    masked) with rows whose limits pass the end of the cache."""
    sq, s = 64, 500
    q, kc, kpr, vc, vpr, pos = _case(2, 2, sq, s, [0, 450], 5)
    kp, kparam = _token_major(kc, kpr)
    vp, vparam = _token_major(vc, vpr)
    got = emulate_chunk(_t(q), slot_reader(kp, kparam, vp, vparam), 2, pos,
                        s, SM)
    plain = tkv.chunk_attention_int4(_t(q), kp, kparam, vp, vparam,
                                     _t(pos), SM)
    torch.testing.assert_close(got, plain, **TOL)


@pytest.mark.parametrize("bs", [128, 256])
def test_tile_order_through_the_table_is_bit_equal(bs):
    """The pool in shuffled blocks: the emulation through the table equals
    the slot cache's bit for bit, as paged_chunk_attention_int4 must equal
    chunk_attention_int4 (chunks straddling a block edge)."""
    sq, s = 96, 512
    q, kc, kpr, vc, vpr, pos = _case(4, 2, sq, s, [100, 400], bs)
    kp, kparam = _token_major(kc, kpr)
    vp, vparam = _token_major(vc, vpr)
    B, nkv = kp.shape[:2]
    mb = s // bs
    rng = np.random.default_rng(bs)
    tbl = torch.from_numpy((rng.permutation(B * mb) + 1).reshape(B, mb)
                           .astype(np.int32))
    pool = []
    for c in (kp, kparam, vp, vparam):
        blocks = torch.zeros((1 + B * mb, nkv, bs, c.shape[-1]),
                             dtype=c.dtype)
        blocks[tbl.long()] = c.reshape(B, nkv, mb, bs, -1).permute(
            0, 2, 1, 3, 4)
        pool.append(blocks)
    slot = emulate_chunk(_t(q), slot_reader(kp, kparam, vp, vparam), nkv,
                         pos, s, SM)
    paged = emulate_chunk(_t(q), paged_reader(*pool, tbl), nkv, pos, mb * bs,
                          SM)
    assert torch.equal(slot, paged)
    torch.testing.assert_close(
        paged, tpk.paged_chunk_attention_int4(_t(q), *pool, tbl, _t(pos),
                                              SM), **TOL)


# ---------------------------------------------------------------------------
# the decoded code tiles
# ---------------------------------------------------------------------------


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm for selectors 0-7: result byte i is byte
    (sel >> 4i) & 7 of the eight bytes of (x, y), x's first."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [
        (y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _bf16x2_minus128(w):
    """fma.rn.bf16x2 w * 1 - 128 on both halves, in torch's bf16."""
    halves = torch.tensor([w & 0xFFFF, w >> 16], dtype=torch.int32)
    v = halves.to(torch.int16).view(torch.bfloat16)
    r = (v * torch.tensor(1.0, dtype=torch.bfloat16)
         - torch.tensor(128.0, dtype=torch.bfloat16))
    bits = r.view(torch.int16).to(torch.int32) & 0xFFFF
    return int(bits[0]) | int(bits[1]) << 16


def _codes_bf16(w):
    """The kernel's codes_bf16: four codes (one a byte) -> two bf16 pairs."""
    return [_bf16x2_minus128(_byte_perm(w, 0x43434343, sel))
            for sel in (0x4140, 0x4342)]


def test_code_to_bf16_is_exact():
    """0x43 over a code n's byte is bf16 128 + n; minus 128 gives n, for
    every code, and the byte selectors keep the codes in column order."""
    for n in range(16):
        v = torch.tensor(0x4300 | n, dtype=torch.int32).to(
            torch.int16).view(torch.bfloat16)
        assert float(v) == 128 + n
        assert float(v - torch.tensor(128.0, dtype=torch.bfloat16)) == n
    rng = np.random.default_rng(0)
    for w in [0x0F0E0D0C, 0x00010203] + list(
            rng.integers(0, 2 ** 32, 64, dtype=np.uint64) & 0x0F0F0F0F):
        w = int(w)
        got = _codes_bf16(w)
        halves = [(got[i // 2] >> (16 * (i % 2))) & 0xFFFF for i in range(4)]
        vals = torch.tensor(halves, dtype=torch.int32).to(torch.int16).view(
            torch.bfloat16).float().tolist()
        assert vals == [(w >> (8 * i)) & 0xFF for i in range(4)]


def _decoded_tile(codes):
    """The kernel's decode of one tile's codes [128, 64] uint8 into the
    bf16 tile image [2 halves][128 keys][128 B] (bytes): 8 code bytes of
    token t, columns 8 c8 .., go to chunk c8 ^ (t % 8) of row t, low
    nibbles in half 0 (dims 8 c8 ..), high nibbles in half 1 (64 + 8 c8
    ..)."""
    img = np.zeros(2 * TS * 128, np.uint8)
    for t in range(TS):
        for c8 in range(8):
            w0, w1 = codes[t, 8 * c8:8 * c8 + 8].view("<u4").tolist()
            lo = _codes_bf16(w0 & 0x0F0F0F0F) + _codes_bf16(w1 & 0x0F0F0F0F)
            hi = (_codes_bf16((w0 >> 4) & 0x0F0F0F0F)
                  + _codes_bf16((w1 >> 4) & 0x0F0F0F0F))
            off = t * 128 + ((c8 ^ (t & 7)) << 4)
            img[off:off + 16] = np.array(lo, "<u4").view(np.uint8)
            img[TS * 128 + off:TS * 128 + off + 16] = np.array(
                hi, "<u4").view(np.uint8)
    return img


def _descriptor_read(img):
    """The tile as both descriptors read it: 128-byte swizzle on a
    1024-byte-aligned tile (16-byte chunk j of row r at j ^ (r % 8)), dims
    0-63 in the half at 0 and 64-127 in the half TS * 128 bytes on. S's B
    (K-major, sw128_desc) takes element (dim d, key n) and P V's B
    (MN-major, sw128_mn_desc with leading offset TS * 128) element (key n,
    dim d) from the same byte: -> [128 keys, 128 dims] float32."""
    vals = img.view("<u2")
    out = np.zeros((TS, 128), np.float32)
    for n in range(TS):
        for d in range(128):
            half, col = divmod(d, 64)
            byte = (half * TS * 128 + n * 128 + (((col // 8) ^ (n & 7)) << 4)
                    + (col % 8) * 2)
            out[n, d] = float(torch.tensor(int(vals[byte // 2]),
                                           dtype=torch.int32)
                              .to(torch.int16).view(torch.bfloat16))
    return out


def test_decoded_tile_layout_is_the_plain_unpack():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 256, (TS, 64)).astype(np.uint8)
    got = _descriptor_read(_decoded_tile(codes))
    np.testing.assert_array_equal(got, _unpack(torch.from_numpy(codes)))


# ---------------------------------------------------------------------------
# the launch glue (a fake library records the calls)
# ---------------------------------------------------------------------------


class _FakeLib:
    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def __getattr__(self, name):
        if not name.startswith("fq_"):
            raise AttributeError(name)

        def fn(*args):
            self.calls.append((name, args))
            return self.rc if name != "fq_error_string" else b"fake failure"
        return fn


@pytest.fixture
def fake(monkeypatch):
    def make(rc=0):
        lib = _FakeLib(rc)
        monkeypatch.setattr(common, "lib", lambda stem: lib)
        monkeypatch.setattr(common, "stream_ptr", lambda t: 1234)
        common.reset_launches()
        return lib
    return make


def _chunk_inputs(B=2, sq=48, nkv=2, n_rep=7, s=512):
    q = torch.zeros((B, sq, nkv * n_rep, 128), dtype=torch.bfloat16)
    kp = torch.zeros((B, nkv, s, 64), dtype=torch.uint8)
    kparam = torch.zeros((B, nkv, s, 2))
    pos = torch.tensor([0, 100][:B], dtype=torch.int32)
    return q, kp, kparam, kp.clone(), kparam.clone(), pos


def test_chunk_launch_glue(fake):
    """One launch: the rows flattened r = rep * Sq + s in float32, R and
    Sq, the cache length; the output back in q's layout and dtype."""
    lib = fake()
    B, sq, nkv, n_rep, s = 2, 48, 2, 7, 512
    q, kp, kparam, vp, vparam, pos = _chunk_inputs(B, sq, nkv, n_rep, s)
    out = tkv._launch_chunk(q, kp, kparam, vp, vparam, pos, SM)
    (name, a), = lib.calls
    assert name == "fq_chunk_attention_int4"
    # q, kp, kpar, vp, vpar, pos, out, B, nkv, R, Sq, S, sm_scale, stream
    assert a[7:12] == (B, nkv, n_rep * sq, sq, s)
    assert a[12] == SM and a[13] == 1234
    assert out.shape == q.shape and out.dtype == q.dtype
    assert common.LAUNCHES["chunk_attention_int4"] == 1


def test_paged_chunk_launch_glue(fake):
    lib = fake()
    B, sq, nkv, n_rep, mb, bs = 2, 48, 2, 4, 3, 256
    q = torch.zeros((B, sq, nkv * n_rep, 128))
    kp = torch.zeros((1 + B * mb, nkv, bs, 64), dtype=torch.uint8)
    kparam = torch.zeros((1 + B * mb, nkv, bs, 2))
    tbl = torch.arange(1, 1 + B * mb, dtype=torch.int32).reshape(B, mb)
    pos = torch.tensor([0, 300], dtype=torch.int32)
    tpk._launch_chunk_paged(q, kp, kparam, kp.clone(), kparam.clone(), tbl,
                            pos, SM)
    (name, a), = lib.calls
    assert name == "fq_paged_chunk_attention_int4"
    # q, kp, kpar, vp, vpar, tbl, pos, out, B, nkv, R, Sq, mb, bs, ...
    assert a[8:14] == (B, nkv, n_rep * sq, sq, mb, bs)
    assert common.LAUNCHES["paged_chunk_attention_int4"] == 1


@pytest.mark.parametrize("paged", [False, True])
def test_chunk_failed_launch_raises_without_fallback(fake, paged):
    lib = fake(rc=1)
    q, kp, kparam, vp, vparam, pos = _chunk_inputs()
    if paged:
        name, entry = ("paged_chunk_attention_int4",
                       "fq_paged_chunk_attention_int4")
        tbl = torch.ones((2, 2), dtype=torch.int32)
        pool = [t[:1, :, :256].contiguous() for t in (kp, kparam, vp, vparam)]
        with pytest.raises(RuntimeError, match=f"{name}: kernel launch "
                           "failed"):
            tpk._launch_chunk_paged(q, *pool, tbl, pos, SM)
    else:
        name, entry = "chunk_attention_int4", "fq_chunk_attention_int4"
        with pytest.raises(RuntimeError, match=f"{name}: kernel launch "
                           "failed"):
            tkv._launch_chunk(q, kp, kparam, vp, vparam, pos, SM)
    assert [c[0] for c in lib.calls] == [entry, "fq_error_string"]
    assert common.LAUNCHES[name] == 0
