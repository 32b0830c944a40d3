"""Row 18's device body (`flash_prefill_attention_kt_i8`,
kernels/prefill_attention.py, csrc/flash_prefill_i8.cu), on the CPU: the
key order of the int8 P V product, the body's walk over key blocks and
tiles, the prepass's chunked extrema, and the launch glue.

The PV product takes p's codes from the s32 score accumulator, which
gives a thread keys 8j + 2tq + {0, 1} of each 8-key column tile, as the
register A of wgmma m64n128k32 s8, which wants k = 4tq .. 4tq + 3 (and
16 + 4tq ..) of each 32-key k-step; V8^T is stored with the keys of every
32-key group in the same order (`v8t_key_order`). The fragment maps below
follow the kernel's packing and mma.sync m16n8k32's A layout (which
wgmma's register A takes per warp): the product of the permuted operands
must give the int32 sums of the codes in key order, and an emulation of
the body (each key block of blk_k walked twice in tiles of 128 keys:
maxima first, then p, codes and P V) must give the plain version's codes
exactly and stay within the bounds of the JAX package's
`flash_prefill_attention_kt_i8` (its Pallas kernel in interpret mode) that
tests/test_torch_baselines.py holds the plain version to.

The CUDA body itself is held to the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py (phases 3i and 11).
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from flatquant_tpu.kernels import prefill_attention as jpa
from flatquant_torch.kernels import common
from flatquant_torch.kernels import prefill_attention as tpa
from flatquant_torch.kernels.tolerance import compare_bf16, compare_flash_i8

torch.set_num_threads(2)

TILE = 128  # keys a tile (csrc/flash_prefill_i8.cu FI_BK)


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _a_fragment_map():
    """(row, k) of wgmma's 64 x 128 register A, over the 4 k-steps of a
    128-key tile, -> the score accumulator's (row, key) whose code the
    kernel packs there. The kernel: accumulator value i of a thread (warp
    w, lane 4 g8 + tq) is row 16 w + g8 + 8 ((i % 4) // 2), key 8 (i // 4)
    + 2 tq + i % 2; its code goes to k-step i // 16, register ((i // 8) %
    2) * 2 + (i % 4) // 2, byte i % 2 + 2 ((i // 4) % 2). mma.sync
    m16n8k32's A: register r, byte y of lane (g8, tq) is row g8 + 8 (r %
    2), k 16 (r // 2) + 4 tq + y."""
    src = {}
    for w in range(4):
        for g8 in range(8):
            for tq in range(4):
                for i in range(64):
                    row = 16 * w + g8 + 8 * ((i % 4) // 2)
                    key = 8 * (i // 4) + 2 * tq + i % 2
                    ks, nt, e = i // 16, i // 4, i % 4
                    reg = ((nt >> 1) & 1) * 2 + (e >> 1)
                    byte = (e & 1) + 2 * (nt & 1)
                    a_row = 16 * w + g8 + 8 * (reg % 2)
                    a_k = 32 * ks + 16 * (reg // 2) + 4 * tq + byte
                    assert a_row == row
                    src[(a_row, a_k)] = (row, key)
    assert len(src) == 64 * 128
    return src


def test_register_a_order_is_v8t_key_order():
    """Every A element's key is the key v8t_key_order stores at its k, so
    the permuted P V equals the codes' P V in key order, in int32."""
    src = _a_fragment_map()
    order = tpa.v8t_key_order(torch.arange(TILE)[None])[0]
    for (a_row, a_k), (row, key) in src.items():
        assert row == a_row and key == order[a_k].item()
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, 128, (64, TILE))).to(torch.int64)
    v8 = torch.from_numpy(rng.integers(-127, 128, (TILE, 128))).to(
        torch.int64)
    a = torch.empty_like(codes)
    for (a_row, a_k), (row, key) in src.items():
        a[a_row, a_k] = codes[row, key]
    v8t = tpa.v8t_key_order(v8.T.contiguous())  # [hd, keys], kernel order
    assert torch.equal(a @ v8t.T, codes @ v8)


def _emulate_body(q, kt, v, sm_scale, pv_i8, blk_k):
    """The body's walk in torch: per key block of blk_k, pass 1 over its
    128-key tiles for the row maxima (taken on the int32 sums, then
    scaled: the scale is positive), pass 2 for p, codes (pv_i8) and
    P V with the operands in the kernel's key order, int32 sums over the
    block; the prepass's scales from per-128-token chunk extrema. Returns
    the output and each block's int32 P V (pv_i8)."""
    B, S, nh, hd = q.shape
    nkv = kt.shape[1]
    n_rep = nh // nkv
    bk = tpa._shrink_to_divisor(min(blk_k, S), S)
    ktf = kt.float()
    vtf = v.float().permute(0, 2, 3, 1)  # [B, nkv, hd, S]
    # the prepass: extrema of each 128-token chunk, then their max
    ks = ktf.reshape(B, nkv, hd, S // 128, 128).abs().amax(dim=(2, 4)).amax(
        -1).clamp_min(1e-30)
    vs = vtf.reshape(B, nkv, hd, S // 128, 128).abs().amax(dim=(2, 4)).amax(
        -1).clamp_min(1e-30)
    k8r, v8r, sc = tpa.quantize_kv_i8_ref(kt, v)
    assert torch.equal(sc, torch.stack([ks / 127.0, vs / 16129.0], -1))
    v8k = tpa.v8t_key_order(v8r)  # as the kernel stores it
    q8, qa = tpa.quantize_q_i8_ref(q, sm_scale)
    q8, qa = q8.permute(0, 2, 1, 3), qa.permute(0, 2, 1, 3)
    rep = (lambda t: t.repeat_interleave(n_rep, dim=1)) if n_rep > 1 else (
        lambda t: t)
    s_scale = qa * rep(sc[..., 0] / 127.0)[..., None, None]
    kf = rep(k8r.float())
    order = tpa.v8t_key_order(torch.arange(TILE)[None])[0]
    vk = rep(v8k.to(torch.int64)) if pv_i8 else None
    vb = tpa._heads_first(v, n_rep).float()
    pv_scale = rep(sc[..., 1])[..., None, None]
    row = torch.arange(S)[:, None]
    m = torch.full((B, nh, S, 1), -math.inf)
    l = torch.zeros((B, nh, S, 1))
    acc = torch.zeros((B, nh, S, hd))
    blocks = []
    for k0 in range(0, S, bk):
        tiles = range(k0, k0 + bk, TILE)

        def sums(t0):  # the int32 sums, -inf above the diagonal
            si = q8 @ kf[:, :, t0:t0 + TILE].transpose(-1, -2)
            return torch.where(row >= t0 + torch.arange(TILE), si, -math.inf)

        def scores(t0):
            return sums(t0) * s_scale
        bm = torch.full((B, nh, S, 1), -math.inf)
        for t0 in tiles:  # pass 1: the max of the sums, then scaled
            bm = torch.maximum(bm, sums(t0).amax(-1, keepdim=True) * s_scale)
        m_new = torch.maximum(m, bm)
        corr = torch.exp2(m - m_new)
        psum = torch.zeros_like(l)
        pvi = torch.zeros((B, nh, S, hd), dtype=torch.int64)
        pvf = torch.zeros((B, nh, S, hd))
        for t0 in tiles:  # pass 2
            p = torch.exp2(scores(t0) - m_new)
            psum = psum + p.sum(-1, keepdim=True)
            if pv_i8:
                codes = torch.round(p * 127.0).to(torch.int64)
                pvi += codes[..., order] @ vk[..., t0:t0 + TILE].transpose(
                    -1, -2)
            else:
                pvf += p.to(torch.bfloat16).float() @ vb[:, :, t0:t0 + TILE]
        l = l * corr + psum
        acc = acc * corr + (pvi.float() * pv_scale if pv_i8 else pvf)
        blocks.append(pvi)
        m = m_new
    out = (acc / torch.clamp_min(l, 1e-30)).to(q.dtype).permute(0, 2, 1, 3)
    return out, blocks


def _plain_blocks(q, kt, v, sm_scale, blk_k):
    """The plain version's int32 P V of each key block (pv_i8), in key
    order, from its own codes."""
    B, S, nh, hd = q.shape
    n_rep = nh // kt.shape[1]
    bk = tpa._shrink_to_divisor(min(blk_k, S), S)
    k8, v8t, sc = tpa.quantize_kv_i8_ref(kt, v)
    q8, qa = tpa.quantize_q_i8_ref(q, sm_scale)
    q8, qa = q8.permute(0, 2, 1, 3), qa.permute(0, 2, 1, 3)
    rep = (lambda t: t.repeat_interleave(n_rep, dim=1)) if n_rep > 1 else (
        lambda t: t)
    s_scale = qa * rep(sc[..., 0] / 127.0)[..., None, None]
    kf, vi = rep(k8.float()), rep(v8t.to(torch.int64))
    row = torch.arange(S)[:, None]
    m = torch.full((B, nh, S, 1), -math.inf)
    out = []
    for k0 in range(0, S, bk):
        s = (q8 @ kf[:, :, k0:k0 + bk].transpose(-1, -2)) * s_scale
        s = torch.where(row >= k0 + torch.arange(bk), s, -math.inf)
        m = torch.maximum(m, s.amax(-1, keepdim=True))
        codes = torch.round(torch.exp2(s - m) * 127.0).to(torch.int64)
        out.append(codes @ vi[..., k0:k0 + bk].transpose(-1, -2))
    return out


@pytest.mark.parametrize("S,nh,nkv,blk_k", [(512, 4, 2, 512),
                                            (384, 4, 4, 512),
                                            (640, 7, 1, 128)])
@pytest.mark.parametrize("pv_i8", [True, False])
def test_body_walk_matches_plain_and_jax(S, nh, nkv, blk_k, pv_i8):
    rng = np.random.default_rng(S + nh)
    q = jnp.asarray(rng.standard_normal((1, S, nh, 128)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((1, S, nkv, 128)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((1, S, nkv, 128)), jnp.bfloat16)
    kt = jnp.transpose(k, (0, 2, 3, 1))
    sm = 1.0 / math.sqrt(128)
    got, blocks = _emulate_body(_t(q), _t(kt), _t(v), sm, pv_i8, blk_k)
    if pv_i8:  # codes and int32 sums are the plain version's
        for a, b in zip(blocks, _plain_blocks(_t(q), _t(kt), _t(v), sm,
                                              blk_k)):
            assert torch.equal(a, b)
    plain = tpa.flash_prefill_attention_kt_i8_ref(_t(q), _t(kt), _t(v), sm,
                                                  pv_i8, blk_k)
    compare_bf16(got, plain, "flash", f"body walk vs plain pv_i8={pv_i8}")
    want = jpa.flash_prefill_attention_kt_i8(q, kt, v, sm, blk_k=blk_k,
                                             pv_i8=pv_i8, interpret=True)
    compare_flash_i8(got, _t(want), _t(v), f"body walk vs JAX pv_i8={pv_i8}")


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
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
        common.reset_launches()
        return lib
    return make


def _qkv(B=2, S=256, nh=8, nkv=2):
    return [torch.zeros((B, S, n, 128), dtype=torch.bfloat16)
            for n in (nh, nkv, nkv)]


@pytest.mark.parametrize("pv_i8", [True, False])
def test_launch_passes_scratch_and_strides(fake, pv_i8):
    """One call runs the prepass and the kernel: K as the token-major
    view in place, the chunk extrema's scratch [B, nkv, S / 128, 2], the
    key block shrunk to a divisor of S, one launch counted."""
    lib = fake()
    B, S, nh, nkv = 2, 384, 8, 2
    q, k, v = _qkv(B, S, nh, nkv)
    kt = k.permute(0, 2, 3, 1)
    out, k8, v8t, sc = tpa._launch_i8(q, kt, v, 0.088, pv_i8, 512)
    (name, args), = lib.calls
    assert name == "fq_flash_prefill_i8"
    assert args[1] == k.data_ptr()
    assert args[3:6] == (k8.data_ptr(), v8t.data_ptr(), sc.data_ptr())
    assert args[8:11] == (S * nh * 128, nh * 128, 128)
    assert args[11:14] == (S * nkv * 128, 128, nkv * 128)
    assert args[14:17] == (S * nkv * 128, nkv * 128, 128)
    assert args[17:23] == (B, S, nh, nkv, 384, int(pv_i8))
    assert args[23] == pytest.approx(0.088 * 1.4426950408889634)
    assert args[24] == 1234
    assert common.LAUNCHES["flash_prefill_attention_kt_i8"] == 1
    assert out.shape == q.shape and sc.shape == (B, nkv, 2)


def test_prepass_alone_is_not_counted(fake):
    lib = fake()
    B, S, nkv = 1, 256, 2
    _, k, v = _qkv(B, S, 4, nkv)
    tpa.kv_quant_i8_prepass(k.permute(0, 2, 3, 1), v)
    (name, args), = lib.calls
    assert name == "fq_kv_quant_i8"
    assert args[6:12] == (S * nkv * 128, 128, nkv * 128, S * nkv * 128,
                          nkv * 128, 128)
    assert args[12:16] == (B, S, nkv, 1)
    assert common.LAUNCHES["flash_prefill_attention_kt_i8"] == 0


def test_failed_launch_raises_without_fallback(fake):
    lib = fake(rc=1)
    q, k, v = _qkv()
    with pytest.raises(RuntimeError, match="flash_prefill_attention_kt_i8: "
                       "kernel launch failed"):
        tpa._launch_i8(q, k.permute(0, 2, 3, 1), v, 0.088, True, 512)
    assert [c[0] for c in lib.calls] == ["fq_flash_prefill_i8",
                                         "fq_error_string"]
    assert common.LAUNCHES["flash_prefill_attention_kt_i8"] == 0


@pytest.mark.parametrize("blk_k", [64, 1024])
def test_key_block_the_body_does_not_take_is_refused(fake, blk_k):
    """A key block below one 128-key tile, or above the 4 tiles of the
    K8 ring that stay for pass 2."""
    lib = fake()
    q, k, v = _qkv(S=2048)
    with pytest.raises(ValueError):
        tpa._launch_i8(q, k.permute(0, 2, 3, 1), v, 0.088, True, blk_k)
    assert lib.calls == []
