"""Rows 2, 10 and 19-21's device body (`decode_attention_int4` and its
twins, kernels/kv_cache.py and kernels/paged_kv.py, csrc/kv_cache.cu), on
the CPU: the split over the sequence and the launch glue.

The body gives each CTA a span of DECODE_SPAN absolute positions, walks
the span's 128-token tiles with an online softmax (float32, scale and zero
folded into the epilogues, or every element dequantized first for rows 19
and 20), and the last span of a (slot, kv head) to take its ticket merges
the spans' partials in a fixed order (`_merge`). A torch emulation of that
order must stay within a few float32 ulps of the plain version and of the
JAX package's Pallas kernels in interpret mode (`decode_attention_int4_v4`
on its lane-transposed layout, `decode_attention_int4` for the dequantized
instance), as the JAX package's own tests run them; and the emulation
through a block table must equal the slot cache's bit for bit, because the
spans are absolute positions (the property chip_smoke.py's phases 3f and 7
assert with torch.equal on the card).

The CUDA body itself is held to the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py (phases 3b, 3f, 3i, 4, 7, 8, 11).
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

TS = 128  # tokens a tile (csrc/kv_cache.cu TS)
SPAN = tkv.DECODE_SPAN
S = 2 * SPAN + 256  # the cache: every edge below fits, and a full slot
# the split's edges: empty, one token, a tile edge inside span 0, one
# span, two, and the whole cache
VALID = [0, 1, 127, 128, 129, SPAN - 1, SPAN, SPAN + 1, S]
SM = 1.0 / math.sqrt(128)
# float32 outputs of size ~1: the body sums in another order than the
# plain version (tiles, spans, the merge's exp(m_j - M) weights) and JAX's
# kernels in a third; all agree to a few ulps
TOL = dict(rtol=1e-5, atol=2e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _unpack(codes):
    """[n, 64] uint8 -> [n, 128] float32 codes, dim c from byte c's low
    nibble, dim 64 + c from its high nibble."""
    c = codes.to(torch.int32)
    return torch.cat([c & 0xF, c >> 4], dim=-1).to(torch.float32)


def slot_reader(kp, kparam, vp, vparam):
    """Tile reader of the slot cache: tokens [t0, t0 + 128) of (b, h)."""
    def read(b, h, t0):
        sl = slice(t0, t0 + TS)
        return kp[b, h, sl], kparam[b, h, sl], vp[b, h, sl], vparam[b, h, sl]
    return read


def paged_reader(kp, kparam, vp, vparam, tbl):
    """Tile reader of the pool through the table, as tile_offset<true>:
    block tbl[b, t0 / bs] from offset t0 % bs (bs % 128 == 0, so a tile
    never straddles a block)."""
    bs = kp.shape[2]

    def read(b, h, t0):
        blk = int(tbl[b, t0 // bs])
        sl = slice(t0 % bs, t0 % bs + TS)
        return (kp[blk, h, sl], kparam[blk, h, sl], vp[blk, h, sl],
                vparam[blk, h, sl])
    return read


def emulate_decode(q, read, nkv, valid_len, s_eff, sm_scale, dequant=False,
                   span=SPAN):
    """The body's order in torch. q [B, nh, 128] float32; read(b, h, t0)
    gives a tile's codes and params. Span j covers positions
    [j * span, (j + 1) * span) of the valid ones; its tiles run the online
    softmax (the max floored at -1e30), P V summed over each tile's two
    token halves apart and the halves added at the span's end; with more
    than one span the partials merge as `_merge` says. Returns
    [B, nh, 128]."""
    B, nh, hd = q.shape
    n_rep = nh // nkv
    out = torch.zeros((B, nh, hd))
    for b in range(B):
        valid = max(min(int(valid_len[b]), s_eff), 0)
        nspan = max(1, -(-valid // span))
        for h in range(nkv):
            qh = q[b, h * n_rep:(h + 1) * n_rep].float()
            qsum = qh.sum(-1)
            parts = []
            for j in range(nspan):
                m = torch.full((n_rep,), -1e30)
                l, z = torch.zeros(n_rep), torch.zeros(n_rep)
                acc = torch.zeros((2, n_rep, hd))  # the tiles' token halves
                hi = min(j * span + span, valid)
                for s0 in range(j * span, hi, TS):
                    n = min(TS, hi - s0)
                    kc, kpr, vc, vpr = (x[:n] for x in read(b, h, s0))
                    ck, cv = _unpack(kc), _unpack(vc)
                    ks, kz = kpr[:, 0], kpr[:, 1]
                    vs, vz = vpr[:, 0], vpr[:, 1]
                    if dequant:
                        sc = qh @ ((ck - kz[:, None]) * ks[:, None]).T * sm_scale
                    else:
                        sc = ((qh @ ck.T - qsum[:, None] * kz[None])
                              * ks[None] * sm_scale)
                    m_new = torch.clamp_min(torch.maximum(m, sc.amax(-1)),
                                            -1e30)
                    p = torch.exp(sc - m_new[:, None])
                    corr = torch.exp(m - m_new)
                    l = l * corr + p.sum(-1)
                    if dequant:
                        pp, cv = p, (cv - vz[:, None]) * vs[:, None]
                    else:
                        pp = p * vs[None]
                        z = z * corr + (pp * vz[None]).sum(-1)
                    h2 = TS // 2
                    pv = torch.stack([pp[:, :h2] @ cv[:h2],
                                      pp[:, h2:] @ cv[h2:]])
                    acc = acc * corr[None, :, None] + pv
                    m = m_new
                parts.append((m, l, z, acc[0] + acc[1]))
            if nspan == 1:
                m, l, z, acc = parts[0]
            else:
                l, z, acc = _merge(parts)
            out[b, h * n_rep:(h + 1) * n_rep] = (
                (acc - z[:, None]) / torch.clamp_min(l, 1e-30)[:, None])
    return out


def _warp_sum(v):
    """A warp's xor butterfly over 32 lanes (v [32, ...]): every lane ends
    with the same sum; lane 0's."""
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[lane ^ o]
    return v[0]


def _merge(parts):
    """The last span's merge: M = max_j m_j; per chunk of 32 spans (a lane
    each) the weights w_j = exp(m_j - M), L and Z as warp sums added chunk
    after chunk; acc as w_j acc_j added over the even spans in turn and
    over the odd ones, then the two sums added."""
    big = torch.stack([p[0] for p in parts]).amax(0)
    l, z, acc = 0.0, 0.0, [0.0, 0.0]
    for j0 in range(0, len(parts), 32):
        chunk = parts[j0:j0 + 32]
        w = torch.stack([torch.exp(p[0] - big) for p in chunk])
        pad = torch.zeros((32 - len(chunk),) + w.shape[1:])
        lw = torch.cat([w * torch.stack([p[1] for p in chunk]), pad])
        zw = torch.cat([w * torch.stack([p[2] for p in chunk]), pad])
        l = l + _warp_sum(lw)
        z = z + _warp_sum(zw)
        for k, (wj, p) in enumerate(zip(w, chunk)):
            acc[k % 2] = acc[k % 2] + wj[:, None] * p[3]
    return l, z, acc[0] + acc[1]


def _case(n_rep, nkv=2, seed=0):
    """Random codes and params in JAX's v4 layout ([B, nkv, 64, S],
    [B, nkv, 2, S]; scale > 0, integer zero), one slot per valid length,
    and q; returned as numpy."""
    rng = np.random.default_rng(seed + n_rep)
    B = len(VALID)
    codes = [rng.integers(0, 256, (B, nkv, 64, S)).astype(np.uint8)
             for _ in range(2)]
    params = [np.stack([rng.uniform(0.01, 0.2, (B, nkv, S)),
                        rng.integers(0, 16, (B, nkv, S))], axis=2)
              .astype(np.float32) for _ in range(2)]
    q = rng.standard_normal((B, nkv * n_rep, 128)).astype(np.float32)
    return q, codes[0], params[0], codes[1], params[1]


def _token_major(codes, params):
    kp, ks, kz = tkv.untranspose_kv(_t(codes), _t(params))
    return kp, torch.cat([ks, kz], -1).contiguous()


@pytest.mark.parametrize("n_rep", [1, 4, 7, 8])
def test_split_order_meets_plain_and_jax(n_rep):
    q, kc, kpr, vc, vpr = _case(n_rep)
    valid = np.array(VALID, np.int32)
    want = jkv.decode_attention_int4_v4(
        jnp.asarray(q), kc, kpr, vc, vpr, jnp.asarray(valid), SM,
        block_s=128, interpret=True)
    kp, kparam = _token_major(kc, kpr)
    vp, vparam = _token_major(vc, vpr)
    got = emulate_decode(_t(q), slot_reader(kp, kparam, vp, vparam), 2,
                         VALID, S, SM)
    plain = tkv.decode_attention_int4(_t(q), kp, kparam, vp, vparam,
                                      _t(valid), SM)
    torch.testing.assert_close(got, plain, **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert bool((got[0] == 0).all())  # valid_len 0 gives 0


@pytest.mark.parametrize("n_rep", [1, 7])
def test_split_dequant_order_meets_plain_and_jax(n_rep):
    """Rows 19 and 20's instance (DEQUANT) against JAX's
    `decode_attention_int4`, which dequantizes every element too."""
    q, kc, kpr, vc, vpr = _case(n_rep, seed=9)
    valid = np.array(VALID, np.int32)
    kp, kparam = _token_major(kc, kpr)
    vp, vparam = _token_major(vc, vpr)
    want = jkv.decode_attention_int4(
        jnp.asarray(q), jnp.asarray(kp.numpy()), jnp.asarray(kparam.numpy()),
        jnp.asarray(vp.numpy()), jnp.asarray(vparam.numpy()),
        jnp.asarray(valid), SM, block_s=128, interpret=True)
    got = emulate_decode(_t(q), slot_reader(kp, kparam, vp, vparam), 2,
                         VALID, S, SM, dequant=True)
    plain = tkv.decode_attention_int4_v1(_t(q), kp, kparam, vp, vparam,
                                         _t(valid), SM)
    torch.testing.assert_close(got, plain, **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_split_merges_more_than_32_spans():
    """A slot longer than 32 spans: the merge's weights and sums run in
    two chunks of lanes."""
    rng = np.random.default_rng(33)
    s = 33 * SPAN + 5
    kp = torch.from_numpy(rng.integers(0, 256, (1, 1, s, 64)).astype(np.uint8))
    vp = torch.from_numpy(rng.integers(0, 256, (1, 1, s, 64)).astype(np.uint8))
    kparam, vparam = (torch.from_numpy(np.stack(
        [rng.uniform(0.01, 0.2, (1, 1, s)), rng.integers(0, 16, (1, 1, s))],
        -1).astype(np.float32)) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((1, 4, 128)).astype(np.float32))
    got = emulate_decode(q, slot_reader(kp, kparam, vp, vparam), 1, [s], s,
                         SM)
    torch.testing.assert_close(
        got, tkv.decode_attention_int4(q, kp, kparam, vp, vparam,
                                       torch.tensor([s]), SM), **TOL)


@pytest.mark.parametrize("bs", [128, 256, 512])
def test_split_through_the_table_is_bit_equal(bs):
    """The pool in shuffled blocks of bs (smaller than, equal to or larger
    than the span), S_eff = mb * bs beyond the slot cache's S: the
    emulation through the table equals the slot cache's bit for bit, as
    paged_decode_attention_int4 must equal decode_attention_int4."""
    q, kc, kpr, vc, vpr = _case(4, seed=3)
    kp, kparam = _token_major(kc, kpr)
    vp, vparam = _token_major(vc, vpr)
    B, nkv = kp.shape[:2]
    mb = -(-S // bs) + 1
    rng = np.random.default_rng(bs)
    tbl = torch.from_numpy((rng.permutation(B * mb) + 1).reshape(B, mb)
                           .astype(np.int32))
    pool = []
    for c in (kp, kparam, vp, vparam):
        pad = torch.zeros((B, nkv, mb * bs - S, c.shape[-1]), dtype=c.dtype)
        full = torch.cat([c, pad], 2).reshape(B, nkv, mb, bs, c.shape[-1])
        blocks = torch.zeros((1 + B * mb, nkv, bs, c.shape[-1]),
                             dtype=c.dtype)
        blocks[tbl.long()] = full.permute(0, 2, 1, 3, 4)
        pool.append(blocks)
    slot = emulate_decode(_t(q), slot_reader(kp, kparam, vp, vparam), nkv,
                          VALID, S, SM)
    paged = emulate_decode(_t(q), paged_reader(*pool, tbl), nkv, VALID,
                           mb * bs, SM)
    assert torch.equal(slot, paged)
    torch.testing.assert_close(
        paged, tpk.paged_decode_attention_int4(_t(q), *pool, tbl,
                                               _t(np.array(VALID)), SM),
        **TOL)


# ---------------------------------------------------------------------------
# the launch glue (a fake library records the calls)
# ---------------------------------------------------------------------------


class _FakeLib:
    """Records each entry point a launch calls with its arguments; returns
    `rc`."""

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
    """A fake library, the tickets reset, and a spy on decode_workspace
    (spy.made: each (workspace, tickets, span) it returned)."""
    monkeypatch.setattr(tkv, "_TICKETS", {})
    made = []
    real = tkv.decode_workspace

    def spy(*a):
        made.append(real(*a))
        return made[-1]
    monkeypatch.setattr(tkv, "decode_workspace", spy)
    monkeypatch.setattr(tpk, "decode_workspace", spy)

    def make(rc=0):
        lib = _FakeLib(rc)
        monkeypatch.setattr(common, "lib", lambda stem: lib)
        monkeypatch.setattr(common, "stream_ptr", lambda t: 1234)
        common.reset_launches()
        return lib
    return make, made


def _inputs(B=3, nkv=2, n_rep=4, s=2048):
    q = torch.zeros((B, nkv * n_rep, 128))
    kp = torch.zeros((B, nkv, s, 64), dtype=torch.uint8)
    kparam = torch.zeros((B, nkv, s, 2))
    return q, kp, kparam, kp.clone(), kparam.clone(), torch.tensor(
        [0, 5, s][:B], dtype=torch.int32)


class _NoHostRead:
    """Patches every way a tensor's values reach the host to raise while
    the launch runs: the wrapper must read no device value."""

    NAMES = ("item", "tolist", "numpy", "__bool__", "__int__", "__float__",
             "__index__")

    def __init__(self, monkeypatch):
        def boom(*a, **k):
            raise AssertionError("a device value was read on the host")
        for n in self.NAMES:
            monkeypatch.setattr(torch.Tensor, n, boom)


@pytest.mark.parametrize("entry", ["fq_decode_attention_int4",
                                   "fq_decode_attention_int4_dequant"])
def test_decode_launch_glue(fake, monkeypatch, entry):
    """One launch a call with the workspace of every span's partial, the
    tickets of every (slot, kv head) and the span; the tickets are made
    once and kept; no value is read on the host."""
    make, made = fake
    lib = make()
    B, nkv, n_rep, s = 3, 2, 4, 2048
    args = _inputs(B, nkv, n_rep, s)
    name = {"fq_decode_attention_int4": "decode_attention_int4",
            "fq_decode_attention_int4_dequant": "decode_attention_int4_v1"}
    with monkeypatch.context() as m:
        _NoHostRead(m)
        for _ in range(2):
            out = tkv._launch_decode(name[entry], entry, *args, SM)
    assert [c[0] for c in lib.calls] == [entry, entry]
    assert common.LAUNCHES[name[entry]] == 2
    assert out.shape == (B, nkv * n_rep, 128)
    ws, tickets, span = made[0]
    assert span == SPAN
    assert ws.dtype == torch.float32
    assert ws.numel() == B * nkv * -(-s // SPAN) * n_rep * (128 + 3)
    assert tickets.dtype == torch.int32 and tickets.numel() == B * nkv
    assert made[1][1].data_ptr() == tickets.data_ptr()  # kept, not remade
    _, a = lib.calls[0]
    # q, kp, kpar, vp, vpar, valid, ws, tickets, out, B, nkv, n_rep, S,
    # span, sm_scale, stream
    assert a[6] == ws.data_ptr() and a[7] == tickets.data_ptr()
    assert a[9:14] == (B, nkv, n_rep, s, SPAN)
    assert a[14] == SM and a[15] == 1234


def test_decode_tickets_grow_and_stay_zero(fake):
    make, made = fake
    make()
    small = tkv.decode_tickets(4, "cpu")
    assert tkv.decode_tickets(3, "cpu").data_ptr() == small.data_ptr()
    big = tkv.decode_tickets(20, "cpu")
    assert big.numel() >= 20 and bool((big == 0).all())
    assert tkv.decode_tickets(8, "cpu").data_ptr() == big.data_ptr()


def test_paged_decode_launch_glue(fake):
    """The paged twin: the same workspace over mb * bs positions, the
    table, one launch."""
    make, made = fake
    lib = make()
    B, nkv, n_rep, mb, bs = 2, 2, 7, 3, 256
    q = torch.zeros((B, nkv * n_rep, 128))
    kp = torch.zeros((1 + B * mb, nkv, bs, 64), dtype=torch.uint8)
    kparam = torch.zeros((1 + B * mb, nkv, bs, 2))
    tbl = torch.arange(1, 1 + B * mb, dtype=torch.int32).reshape(B, mb)
    valid = torch.tensor([700, 3], dtype=torch.int32)
    tpk._launch_decode_paged(q, kp, kparam, kp.clone(), kparam.clone(), tbl,
                             valid, SM)
    (name, a), = lib.calls
    assert name == "fq_paged_decode_attention_int4"
    ws, tickets, span = made[0]
    assert ws.numel() == B * nkv * -(-(mb * bs) // SPAN) * n_rep * 131
    # q, kp, kpar, vp, vpar, tbl, valid, ws, tickets, out, B, nkv, n_rep,
    # mb, bs, span, sm_scale, stream
    assert a[7] == ws.data_ptr() and a[8] == tickets.data_ptr()
    assert a[10:16] == (B, nkv, n_rep, mb, bs, SPAN)
    assert common.LAUNCHES["paged_decode_attention_int4"] == 1


@pytest.mark.parametrize("paged", [False, True])
def test_decode_failed_launch_raises_without_fallback(fake, paged):
    make, _ = fake
    lib = make(rc=1)
    q, kp, kparam, vp, vparam, valid = _inputs()
    if paged:
        tbl = torch.ones((3, 8), dtype=torch.int32)
        pool = [t[:1, :, :256].contiguous() for t in (kp, kparam, vp, vparam)]
        name, entry = ("paged_decode_attention_int4",
                       "fq_paged_decode_attention_int4")
        with pytest.raises(RuntimeError, match=f"{name}: kernel launch "
                           "failed"):
            tpk._launch_decode_paged(q, *pool, tbl, valid, SM)
    else:
        name, entry = "decode_attention_int4", "fq_decode_attention_int4"
        with pytest.raises(RuntimeError, match=f"{name}: kernel launch "
                           "failed"):
            tkv._launch_decode(name, entry, q, kp, kparam, vp, vparam, valid,
                               SM)
    assert [c[0] for c in lib.calls] == [entry, "fq_error_string"]
    assert common.LAUNCHES[name] == 0
