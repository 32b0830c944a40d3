"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA card; on a host without one every test here skips. This file
imports neither JAX nor the JAX package, so it also runs on a GPU machine
without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu

(--noconftest: tests/conftest.py configures JAX.)
"""

import pytest
import torch

from flatquant_torch.kernels import attn_prologue as tap
from flatquant_torch.kernels import common
from flatquant_torch.kernels import flat_pipeline as tfp
from flatquant_torch.kernels import grouped_mlp as tgm
from flatquant_torch.kernels import int4_matmul as tmm
from flatquant_torch.kernels import kv_cache as tkv
from flatquant_torch.kernels import paged_kv as tpk
from flatquant_torch.kernels import prefill_attention as tpa
from flatquant_torch.kernels.tolerance import (
    compare_bf16,
    compare_codes,
    compare_kv,
    compare_scales,
)
from flatquant_torch.models.config import LlamaConfig


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain GEMM is exact
    return torch.device("cuda")


# row 1's M on both sides of the route's crossover and ragged, N (576 is
# DeepSeek-V2-Lite's wkv_a, 64 mod 128) and K (96: one stage; 2816 and
# 10944: DeepSeek's, K/2 % 64 != 0; 11008: llama-2-7b's down)
ROW1_M = (1, 4, tmm.TILE_MIN_M - 1, tmm.TILE_MIN_M, 300, 2048)
ROW1_NK = [(n, k) for n in (576, 4096, 12288)
           for k in (96, 2816, 4096, 10944, 11008)]


def _row1_inputs(cuda, m, n, k, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    xq = torch.randint(-8, 8, (m, k), generator=g, device=cuda,
                       dtype=torch.int8)
    xs = torch.rand((m, 1), generator=g, device=cuda) + 0.01
    wp = torch.randint(0, 256, (n, k // 2), generator=g, device=cuda,
                       dtype=torch.uint8)
    sw = torch.rand((n,), generator=g, device=cuda) * 0.05
    return xq, xs, wp, sw


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", [(1, 4096, 4096), (8, 1024, 11008),
                                   (40, 384, 512)]
                         + [(m, n, k) for m in ROW1_M for n, k in ROW1_NK])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_w4a4_matmul_i8_bit_exact(cuda, m, n, k, out):
    xq, xs, wp, sw = _row1_inputs(cuda, m, n, k, m)
    body = tmm.w4a4_body(m, n, k)
    before = common.LAUNCHES["w4a4_matmul_i8"]
    by_body = common.BODY_LAUNCHES["w4a4_matmul_i8"][body]
    got = tmm.w4a4_matmul_i8(xq, xs, wp, sw, out)
    assert common.LAUNCHES["w4a4_matmul_i8"] == before + 1
    assert common.BODY_LAUNCHES["w4a4_matmul_i8"][body] == by_body + 1
    assert torch.equal(got, tmm.w4a8_matmul_ref(xq, xs, wp, sw, out))


@pytest.mark.gpu
@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("m", [1, 4, tmm.TILE_MIN_M, 300, 2048])
def test_w4a4_matmul_i8_bodies_agree(cuda, monkeypatch, m, grouped):
    """Both entry points at the same M: equal to each other and to the
    plain version, bit for bit."""
    n, k = 576, 2816
    xq, xs, wp, sw = _row1_inputs(cuda, m, n, k, m + 7)
    x_in = tgm.group_layout(xq, k // 128) if grouped else xq
    fn = tgm.w4a4_matmul_i8_grouped if grouped else tmm.w4a4_matmul_i8
    ys = {}
    for body in ("stream", "tile"):
        monkeypatch.setattr(tmm, "w4a4_body", lambda m_, n_, k_: body)
        ys[body] = fn(x_in, xs, wp, sw, torch.float32)
    assert torch.equal(ys["stream"], ys["tile"])
    assert torch.equal(ys["tile"],
                       tmm.w4a8_matmul_ref(xq, xs, wp, sw, torch.float32))


def _cache(g, cuda, B, nkv, S):
    u8 = dict(generator=g, device=cuda, dtype=torch.uint8)
    kp = torch.randint(0, 256, (B, nkv, S, 64), **u8)
    vp = torch.randint(0, 256, (B, nkv, S, 64), **u8)
    kpar = torch.rand((B, nkv, S, 2), generator=g, device=cuda)
    vpar = torch.rand((B, nkv, S, 2), generator=g, device=cuda)
    return kp, kpar, vp, vpar


# valid lengths of the decode tests: the split's span edges (a tile edge
# inside the first span, one span, two), 0 beside them, and a full cache
SPAN = tkv.DECODE_SPAN
DECODE_VALID = [(0, 200, 512), (1, 127, 128), (129, SPAN - 1, SPAN),
                (SPAN + 1, 2 * SPAN + 1, 2048)]


@pytest.mark.gpu
@pytest.mark.parametrize("valid_l", DECODE_VALID)
@pytest.mark.parametrize("nh,nkv", [(8, 8), (8, 2), (28, 4), (10, 2)])
def test_decode_attention_int4_matches_plain(cuda, nh, nkv, valid_l):
    g = torch.Generator(device=cuda).manual_seed(nkv)
    B, S = 3, 2048
    kp, kpar, vp, vpar = _cache(g, cuda, B, nkv, S)
    q = torch.randn((B, nh, 128), generator=g, device=cuda)
    valid = torch.tensor(valid_l, device=cuda, dtype=torch.int32)
    got = tkv.decode_attention_int4(q, kp, kpar, vp, vpar, valid, 0.088)
    want = tkv.decode_attention_ref(q, kp, kpar[..., :1], kpar[..., 1:], vp,
                                    vpar[..., :1], vpar[..., 1:], valid,
                                    0.088)
    # float32 outputs: scale/zero folded into the epilogues and another
    # summation order than the plain version
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert bool((got[valid == 0] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["decode_attention_int4",
                                  "decode_attention_int4_v1"])
def test_decode_attention_int4_qwen_b1(cuda, name):
    """Qwen-2.5-7B's decode at B=1 (28/4 heads) over 2048 valid positions:
    every span of the split merged by the last one, twice in a row (the
    tickets are back at 0 after each launch)."""
    g = torch.Generator(device=cuda).manual_seed(28)
    kp, kpar, vp, vpar = _cache(g, cuda, 1, 4, 2048)
    q = torch.randn((1, 28, 128), generator=g, device=cuda)
    valid = torch.tensor([2048], device=cuda, dtype=torch.int32)
    fn = getattr(tkv, name)
    got = _launched(name, fn, q, kp, kpar, vp, vpar, valid, 0.088)
    want = tkv.decode_attention_ref(q, kp, kpar[..., :1], kpar[..., 1:], vp,
                                    vpar[..., :1], vpar[..., 1:], valid,
                                    0.088)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got, fn(q, kp, kpar, vp, vpar, valid, 0.088))
    assert int(tkv.decode_tickets(4, q.device).abs().sum()) == 0


@pytest.mark.gpu
def test_write_token_bit_exact_in_place(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    caches = list(_cache(g, cuda, 3, 2, 512))
    copies = [c.clone() for c in caches]
    new = [c[:, :, :1].clone() for c in _cache(g, cuda, 3, 2, 1)]
    pos = torch.tensor([5, 511, 1000], device=cuda, dtype=torch.int32)
    ptrs = [c.data_ptr() for c in caches]
    out = tkv.write_token(*caches, *new, pos)
    tkv.write_token_ref(*copies, *new, pos)
    assert [c.data_ptr() for c in out] == ptrs
    for a, b in zip(caches, copies):
        assert torch.equal(a, b)


def _misaligned(t):
    """t's values in a contiguous tensor whose address is 1 byte past a
    16-byte boundary (the kernel's byte-wise path)."""
    buf = torch.empty(t.numel() * t.element_size() + 16, dtype=torch.uint8,
                      device=t.device)
    out = buf[1:1 + t.numel() * t.element_size()].view(t.dtype).view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("B,nkv,hdh,pos,shift", [
    (1, 4, 64, [300], False),  # Qwen's GQA 28/4 at B = 1
    (4, 2, 64, [0, 511, 512, -1], False),  # positions 0, S - 1, S and -1
    (3, 2, 36, [0, 77, 511], False),  # 36-byte code rows
    (2, 3, 64, [7, 400], True),  # new codes 1 byte past a 16-byte boundary
])
def test_write_token_cases_bit_exact(cuda, B, nkv, hdh, pos, shift):
    g = torch.Generator(device=cuda).manual_seed(B)
    caches = [c[..., :hdh].contiguous() if c.dtype == torch.uint8 else c
              for c in _cache(g, cuda, B, nkv, 512)]
    copies = [c.clone() for c in caches]
    new = [(c[:, :, :1, :hdh] if c.dtype == torch.uint8 else c[:, :, :1])
           .clone() for c in _cache(g, cuda, B, nkv, 1)]
    if shift:
        new = [_misaligned(c) if c.dtype == torch.uint8 else c for c in new]
        assert new[0].data_ptr() % 16 == 1
    pos = torch.tensor(pos, device=cuda, dtype=torch.int32)
    _launched("write_token", tkv.write_token, *caches, *new, pos)
    tkv.write_token_ref(*copies, *new, pos)
    for a, b in zip(caches, copies):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the prefill kernels, with identity and with random orthogonal factors
# (flatquant_torch/kernels/tolerance.py states both modes' tolerances)
# ---------------------------------------------------------------------------

MODES = ["identity", "orthogonal"]


def _factor(g, cuda, n, mode):
    if mode == "identity":
        return torch.eye(n, device=cuda)
    q, r = torch.linalg.qr(torch.randn((n, n), generator=g, device=cuda,
                                       dtype=torch.float64))
    return (q * torch.sign(torch.diagonal(r))).float()


def _launched(name, fn, *a, **kw):
    before = common.LAUNCHES[name]
    out = fn(*a, **kw)
    assert common.LAUNCHES[name] == before + 1
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("t,h,dtype", [(300, 4096, torch.bfloat16),
                                       (40, 256, torch.float32),
                                       (1, 4096, torch.bfloat16),
                                       (2048, 4096, torch.bfloat16),
                                       (40, 8192, torch.float32)])
def test_rmsnorm_right_flat_matches_plain(cuda, mode, t, h, dtype):
    g = torch.Generator(device=cuda).manual_seed(t)
    x = (torch.randn((t, h), generator=g, device=cuda) * 2).to(dtype)
    w = torch.rand((h,), generator=g, device=cuda) + 0.5
    right = _factor(g, cuda, 128, mode)
    got = _launched("rmsnorm_right_flat", tfp.rmsnorm_right_flat, x, w,
                    right, 1e-5)
    want = tfp.rmsnorm_right_flat_ref(x, w, right, 1e-5)
    compare_bf16(got, want, mode, "rmsnorm_right_flat")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("t,grp,clip", [(100, 32, None), (37, 86, (0.9, 0.95)),
                                        (8, 2, (0.97, 0.9)),
                                        (1000, 86, (0.9, 0.95)),
                                        (2047, 128, None)])
def test_left_quant_i8_flat_matches_plain(cuda, mode, t, grp, clip):
    """T = 1000 and 2047: tokens not a multiple of the persistent grid
    (one block an SM, tokens t, t + grid, ...); G = 86 and 128 take two M
    tiles of wgmma, G = 2 a slab padded from 2 to 16 rows."""
    g = torch.Generator(device=cuda).manual_seed(grp)
    x = (torch.randn((t, grp * 128), generator=g, device=cuda) * 3).to(
        torch.bfloat16)
    x[t // 2] = 0  # an all-zero row: scale 1, codes 0
    left_t = _factor(g, cuda, grp, mode)
    if clip is not None:
        clip = tuple(torch.tensor(c, device=cuda) for c in clip)
    q, s = _launched("left_quant_i8_flat", tfp.left_quant_i8_flat, left_t,
                     x, clip)
    q_ref, s_ref = tfp.left_quant_i8_flat_ref(left_t, x, clip)
    compare_codes(q, q_ref, mode, "left_quant_i8_flat")
    compare_scales(s, s_ref, mode, "left_quant_i8_flat")
    assert s[t // 2].item() == 1.0 and not q[t // 2].any()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m,k,nh", [(200, 512, 384), (64, 4096, 256),
                                    (33, 2816, 128), (2048, 4096, 256)])
def test_w4a4_matmul_i8_swiglu_right_matches_plain(cuda, mode, m, k, nh):
    g = torch.Generator(device=cuda).manual_seed(m)
    xq = torch.randint(-8, 8, (m, k), generator=g, device=cuda,
                       dtype=torch.int8)
    xs = torch.rand((m, 1), generator=g, device=cuda) * 0.2 + 0.01
    wp = torch.randint(0, 256, (2 * nh, k // 2), generator=g, device=cuda,
                       dtype=torch.uint8)
    sw = torch.rand((2 * nh,), generator=g, device=cuda) * 0.01 + 1e-3
    right = _factor(g, cuda, 128, mode)
    got = _launched("w4a4_matmul_i8_swiglu_right",
                    tfp.w4a4_matmul_i8_swiglu_right, xq, xs, wp, sw, right)
    want = tfp.w4a4_matmul_i8_swiglu_right_ref(xq, xs, wp, sw, right)
    compare_bf16(got, want, mode, "w4a4_matmul_i8_swiglu_right")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,L,pos,nh,nkv", [
    (2, 256, 384, 64, 8, 2),       # GQA, cache written at [64, 320)
    (1, 2048, 2048, 0, 32, 32),    # llama-2-7b's 1 x 2048
    (1, 2048, 2304, 0, 28, 4),     # Qwen-2.5-7B's, n_rep 7
    (2, 200, 512, 37, 8, 2)])      # a ragged token tile at an odd pos
def test_attn_prologue_matches_plain(cuda, mode, dtype, B, S, L, pos, nh,
                                     nkv):
    """Each dtype's body (bf16: the tensor-core body, float32: the
    CUDA-core one) against the plain version; with identity factors the
    bf16 body's q_rot / k_rot and K codes are bit-exact."""
    g = torch.Generator(device=cuda).manual_seed(7)
    qkv = (torch.randn((B, S, (nh + 2 * nkv) * 128), generator=g,
                       device=cuda) * 2).to(dtype)
    ang = torch.rand((S, 128), generator=g, device=cuda) * 6.3
    cos, sin = torch.cos(ang), torch.sin(ang)
    k_t = _factor(g, cuda, 128, mode)
    k_t_inv = _factor(g, cuda, 128, mode)
    kc = (torch.tensor(0.93, device=cuda), torch.tensor(0.9, device=cuda))
    cache = [torch.zeros((B, nkv, L, 64), dtype=torch.uint8, device=cuda),
             torch.zeros((B, nkv, L, 2), device=cuda),
             torch.zeros((B, nkv, L, 64), dtype=torch.uint8, device=cuda),
             torch.zeros((B, nkv, L, 2), device=cuda)]
    ref_cache = [c.clone() for c in cache]
    body = tap.prologue_body(dtype)
    by_body = common.BODY_LAUNCHES["attn_prologue"][body]
    got = _launched("attn_prologue", tap.attn_prologue, qkv, cos, sin, k_t,
                    k_t_inv, kc, None, nh=nh, nkv=nkv, cache=cache, pos=pos)
    assert common.BODY_LAUNCHES["attn_prologue"][body] == by_body + 1
    want = tap.attn_prologue_ref(qkv, cos, sin, k_t, k_t_inv, kc, None,
                                 nh=nh, nkv=nkv, cache=ref_cache, pos=pos)
    assert all(a is b for a, b in zip(got[3:], cache))
    for i, name in ((0, "q_rot"), (1, "k_rot")):
        if dtype == torch.bfloat16:
            compare_bf16(got[i], want[i], mode, name)
            if mode == "identity":
                assert torch.equal(got[i], want[i]), name
        else:  # float32 sums of 128 products in another order
            torch.testing.assert_close(got[i], want[i], rtol=1e-5,
                                       atol=1e-5)
    assert torch.equal(got[2], want[2])
    compare_kv(cache[0], cache[1], ref_cache[0], ref_cache[1], mode, "K")
    # V is quantized from the raw qkv values: exact in both modes
    compare_kv(cache[2], cache[3], ref_cache[2], ref_cache[3], "identity",
               "V")


@pytest.mark.gpu
def test_plain_quant_divides_like_the_cpu(cuda):
    """The plain versions' per-token and KV scales use IEEE division on
    the card too (torch on CUDA multiplies by the reciprocal of a
    Python-number divisor, one float32 ulp off JAX's quotient)."""
    from flatquant_torch.serving.quantized import _act_codes_i8

    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((512, 1024), generator=g, device=cuda) * 3
    for a, b in zip(_act_codes_i8(x, None, 7), _act_codes_i8(x.cpu(), None, 7)):
        assert torch.equal(a.cpu(), b)
    t = x.reshape(4, 128, 8, 128)
    for a, b in zip(tkv.quantize_pack_kv(t), tkv.quantize_pack_kv(t.cpu())):
        assert torch.equal(a.cpu(), b)


# ---------------------------------------------------------------------------
# flash prefill attention, both entry points (tolerance mode "flash")
# ---------------------------------------------------------------------------


def _flash_inputs(g, cuda, B, S, nh, nkv, hd=128, dtype=torch.bfloat16):
    return [torch.randn((B, S, n, hd), generator=g, device=cuda).to(dtype)
            for n in (nh, nkv, nkv)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,nh,nkv", [(1, 1024, 4, 4), (2, 1152, 8, 2),
                                        (1, 2048, 32, 8), (1, 2048, 28, 4),
                                        (1, 4096, 32, 32)])
def test_flash_prefill_attention_matches_plain(cuda, B, S, nh, nkv):
    g = torch.Generator(device=cuda).manual_seed(S + nkv)
    q, k, v = _flash_inputs(g, cuda, B, S, nh, nkv)
    got = _launched("flash_prefill_attention", tpa.flash_prefill_attention,
                    q, k, v, 0.088)
    want = tpa.flash_prefill_attention_ref(q, k, v, 0.088)
    compare_bf16(got, want, "flash", "flash_prefill_attention")


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["token-major view", "contiguous"])
def test_flash_prefill_attention_kt_matches_plain(cuda, layout):
    """The fused route's strided view of the prologue's token-major K, and
    JAX's contiguous [B, nkv, hd, S] (copied token-major by the wrapper)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = _flash_inputs(g, cuda, 2, 1024, 8, 4)
    kt = k.permute(0, 2, 3, 1)
    if layout == "contiguous":
        kt = kt.contiguous()
    got = _launched("flash_prefill_attention_kt",
                    tpa.flash_prefill_attention_kt, q, kt, v, 0.088)
    want = tpa.flash_prefill_attention_kt_ref(q, kt, v, 0.088)
    compare_bf16(got, want, "flash", "flash_prefill_attention_kt")


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["float32", "head_dim 64", "S 1000"])
def test_flash_prefill_attention_raises_on_what_it_does_not_take(cuda, what):
    g = torch.Generator(device=cuda).manual_seed(5)
    S = 1000 if what == "S 1000" else 1024
    hd = 64 if what == "head_dim 64" else 128
    dtype = torch.float32 if what == "float32" else torch.bfloat16
    q, k, v = _flash_inputs(g, cuda, 1, S, 4, 2, hd, dtype)
    before = dict(common.LAUNCHES)
    with pytest.raises(ValueError):
        tpa.flash_prefill_attention(q, k, v, 0.1)
    with pytest.raises(ValueError):
        tpa.flash_prefill_attention_kt(q, k.permute(0, 2, 3, 1), v, 0.1)
    assert common.LAUNCHES == before


# ---------------------------------------------------------------------------
# chunk attention and the paged twins (one body each with the slot kernels)
# ---------------------------------------------------------------------------


def _paged_state(g, cuda, B, nkv, mb, bs):
    """A random pool of 1 + B*mb blocks, a shuffled table, and the same
    cache gathered slot-major (the slot kernels' input)."""
    pool = _cache(g, cuda, 1 + B * mb, nkv, bs)
    perm = torch.randperm(B * mb, generator=g, device=cuda) + 1
    tbl = perm.reshape(B, mb).to(torch.int32)
    kc, kpr = tpk.gather_kv_paged(pool[0], pool[1], tbl)
    vc, vpr = tpk.gather_kv_paged(pool[2], pool[3], tbl)
    return pool, tbl, (kc.contiguous(), kpr.contiguous(), vc.contiguous(),
                       vpr.contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("nh,nkv,sq", [(8, 8, 64), (8, 2, 40), (4, 4, 1),
                                       (28, 4, 40), (10, 2, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_attention_int4_matches_plain(cuda, nh, nkv, sq, dtype):
    g = torch.Generator(device=cuda).manual_seed(nh + sq)
    B, S = 3, 640
    cache = _cache(g, cuda, B, nkv, S)
    q = torch.randn((B, sq, nh, 128), generator=g, device=cuda).to(dtype)
    pos = torch.tensor([0, 300, S - sq], device=cuda, dtype=torch.int32)
    got = _launched("chunk_attention_int4", tkv.chunk_attention_int4, q,
                    *cache, pos, 0.088)
    want = tkv.chunk_attention_ref(q, *cache, pos, 0.088)
    assert got.dtype == dtype and got.shape == q.shape
    # float32: scale/zero folded into the epilogues, another summation
    # order; bf16 outputs may round one ulp apart
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("nh,nkv", [(32, 32), (28, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_attention_int4_long_history(cuda, nh, nkv, dtype):
    """The batcher's last chunk of a 2048-token cache: Sq = 256 at pos
    1792, every 128-key tile of the history on the tensor cores."""
    g = torch.Generator(device=cuda).manual_seed(1792 + nkv)
    S, sq = 2048, 256
    cache = _cache(g, cuda, 1, nkv, S)
    q = torch.randn((1, sq, nh, 128), generator=g, device=cuda).to(dtype)
    pos = torch.tensor([S - sq], device=cuda, dtype=torch.int32)
    got = _launched("chunk_attention_int4", tkv.chunk_attention_int4, q,
                    *cache, pos, 0.088)
    want = tkv.chunk_attention_ref(q, *cache, pos, 0.088)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("nh,nkv", [(8, 8), (8, 2), (28, 4)])
def test_paged_decode_attention_int4_equals_the_slot_kernel(cuda, nh, nkv):
    g = torch.Generator(device=cuda).manual_seed(nkv)
    B, mb, bs = 4, 3, 256
    pool, tbl, slot = _paged_state(g, cuda, B, nkv, mb, bs)
    q = torch.randn((B, nh, 128), generator=g, device=cuda)
    valid = torch.tensor([0, 255, 256, 700], device=cuda, dtype=torch.int32)
    if nkv == 2:  # the split's span edges
        valid = torch.tensor([SPAN - 1, SPAN, SPAN + 1, 2 * SPAN + 1],
                             device=cuda, dtype=torch.int32)
    got = _launched("paged_decode_attention_int4",
                    tpk.paged_decode_attention_int4, q, *pool, tbl, valid,
                    0.088)
    want = tpk.paged_decode_attention_ref(q, *pool, tbl, valid, 0.088)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    # the same body as the slot kernel, span by span: bit for bit
    assert torch.equal(got, tkv.decode_attention_int4(q, *slot, valid, 0.088))
    assert bool((got[valid == 0] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("nh,nkv", [(8, 8), (8, 2), (28, 4)])
def test_paged_chunk_attention_int4_equals_the_slot_kernel(cuda, nh, nkv):
    g = torch.Generator(device=cuda).manual_seed(10 + nkv)
    B, mb, bs, sq = 2, 4, 128, 96
    pool, tbl, slot = _paged_state(g, cuda, B, nkv, mb, bs)
    q = torch.randn((B, sq, nh, 128), generator=g, device=cuda)
    pos = torch.tensor([100, 400], device=cuda, dtype=torch.int32)  # straddle
    got = _launched("paged_chunk_attention_int4",
                    tpk.paged_chunk_attention_int4, q, *pool, tbl, pos, 0.088)
    want = tpk.paged_chunk_attention_ref(q, *pool, tbl, pos, 0.088)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got, tkv.chunk_attention_int4(q, *slot, pos, 0.088))


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["head_dim 64", "n_rep 9", "block 64"])
def test_paged_attention_raises_on_what_it_does_not_take(cuda, what):
    g = torch.Generator(device=cuda).manual_seed(3)
    bs = 64 if what == "block 64" else 128
    nkv = 1 if what == "n_rep 9" else 2
    nh = 9 if what == "n_rep 9" else 4
    pool, tbl, _ = _paged_state(g, cuda, 2, nkv, 2, bs)
    hd = 64 if what == "head_dim 64" else 128
    q = torch.randn((2, 8, nh, hd), generator=g, device=cuda)
    pos = torch.tensor([0, 8], device=cuda, dtype=torch.int32)
    before = dict(common.LAUNCHES)
    with pytest.raises(ValueError):
        tpk.paged_chunk_attention_int4(q, *pool, tbl, pos, 0.1)
    with pytest.raises(ValueError):
        tpk.paged_decode_attention_int4(q[:, 0], *pool, tbl, pos + 1, 0.1)
    assert common.LAUNCHES == before


# ---------------------------------------------------------------------------
# rows 12-14: quant_acts_i8, w4a4_matmul_i8_swiglu, w4a8_matmul
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,dtype,q_max,clip", [
    (300, 384, torch.bfloat16, 7, (0.83, 0.91)),
    (256, 18944, torch.bfloat16, 7, None),
    (64, 8192, torch.float32, 127, None),
    (5, 28672, torch.float32, 7, (0.98, 0.98)),
])
def test_quant_acts_i8_bit_exact(cuda, m, k, dtype, q_max, clip):
    g = torch.Generator(device=cuda).manual_seed(k)
    x = (torch.randn((m, k), generator=g, device=cuda) * 3).to(dtype)
    x[1] = 0  # zero row: scale 1, codes 0
    x[2] = -x[2].abs()  # no positive value
    c = None if clip is None else tuple(torch.tensor(v, device=cuda)
                                        for v in clip)
    q, s = _launched("quant_acts_i8", tmm.quant_acts_i8, x, c, q_max)
    q_ref, s_ref = tmm.quant_acts_i8_ref(x, c, q_max)
    # IEEE division in both: codes and scales bit for bit
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    assert not q[1].any() and s[1].item() == 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,nh", [(200, 512, 384), (300, 3584, 256),
                                    (64, 896, 8448), (33, 2880, 384)])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_w4a4_matmul_i8_swiglu_matches_plain(cuda, m, k, nh, out):
    g = torch.Generator(device=cuda).manual_seed(m + k)
    xq = torch.randint(-8, 8, (m, k), generator=g, device=cuda,
                       dtype=torch.int8)
    xs = torch.rand((m, 1), generator=g, device=cuda) * 0.1 + 1e-3
    wp = torch.randint(0, 256, (2 * nh, k // 2), generator=g, device=cuda,
                       dtype=torch.uint8)
    sw = torch.rand((2 * nh,), generator=g, device=cuda) * 0.01 + 1e-4
    got = _launched("w4a4_matmul_i8_swiglu", tmm.w4a4_matmul_i8_swiglu, xq,
                    xs, wp, sw, out)
    want = tmm.w4a4_matmul_i8_swiglu_ref(xq, xs, wp, sw, out)
    assert got.dtype == out and got.shape == (m, nh)
    # exact integer sums; the epilogue's expf may be an ulp from torch.exp
    if out == torch.bfloat16:
        compare_bf16(got, want, "identity", "w4a4_matmul_i8_swiglu")
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _w4a8_inputs(cuda, m, n, k, acts, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    if acts == "codes":
        x = torch.randint(-8, 8, (m, k), generator=g, device=cuda).to(
            torch.bfloat16)
        xs = torch.rand((m, 1), generator=g, device=cuda) + 0.01
    else:
        x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
        xs = torch.ones((m, 1), device=cuda)
    wp = torch.randint(0, 256, (n, k // 2), generator=g, device=cuda,
                       dtype=torch.uint8)
    sw = torch.rand((n,), generator=g, device=cuda) * 0.01 + 1e-4
    return x, xs, wp, sw


def _w4a8_held(got, want, acts, out):
    if acts == "codes":  # integer sums: exact in any order
        assert torch.equal(got, want), out
    elif out == torch.float32:  # float32 sums in another order
        scale = want.abs().amax(dim=-1, keepdim=True)
        assert ((got - want).abs() <= 1e-5 * scale).all()
    else:
        compare_bf16(got, want, "identity", "w4a8_matmul")


@pytest.mark.gpu
@pytest.mark.parametrize("body", tmm.W4A8_BODIES)
@pytest.mark.parametrize("m,n,k", [(9, 999, 2880), (33, 4096, 4096),
                                   (200, 1000, 11008), (2048, 576, 2880)])
@pytest.mark.parametrize("acts", ["codes", "bf16 activations"])
def test_w4a8_matmul_bodies_match_plain(cuda, monkeypatch, body, m, n, k,
                                        acts):
    """Each body forced at ragged M and N, at K % 128 == 64 (a last stage
    of 32 packed bytes in the tile), both output types; counted by body."""
    x, xs, wp, sw = _w4a8_inputs(cuda, m, n, k, acts, m + n)
    monkeypatch.setattr(tmm, "w4a8_body", lambda m_, n_: body)
    for out in (torch.float32, torch.bfloat16):
        before = common.BODY_LAUNCHES["w4a8_matmul"][body]
        got = tmm.w4a8_matmul(x, xs, wp, sw, out)
        assert common.BODY_LAUNCHES["w4a8_matmul"][body] == before + 1
        _w4a8_held(got, tmm.w4a8_matmul_rowsum_ref(x, xs, wp, sw, out), acts,
                   out)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 4, 8, 9, 33, 300])
@pytest.mark.parametrize("n,k", [(384, 512), (4096, 11008)])
@pytest.mark.parametrize("acts", ["codes", "bf16 activations"])
def test_w4a8_matmul_matches_plain(cuda, m, n, k, acts):
    x, xs, wp, sw = _w4a8_inputs(cuda, m, n, k, acts, m * n)
    for out in (torch.float32, torch.bfloat16):
        got = _launched("w4a8_matmul", tmm.w4a8_matmul, x, xs, wp, sw, out)
        _w4a8_held(got, tmm.w4a8_matmul_rowsum_ref(x, xs, wp, sw, out), acts,
                   out)


def _small_model(fq, seed=0):
    """A 2-layer model of mini widths (head_dim 128, K % 64 == 0), random
    weights and orthogonal balanced-split transforms, packed by the port
    on the CPU."""
    from flatquant_torch.core.kron import get_decompose_dim
    from flatquant_torch.models.llama import init_params
    from flatquant_torch.serving.quantized import (
        build_serving_layer, kron_transform)

    cfg = LlamaConfig(name="mini", vocab_size=256, hidden_size=512,
                      intermediate_size=1536, num_layers=2, num_heads=4,
                      num_kv_heads=2, head_dim=128, attn_bias=True)
    p = init_params(cfg, seed=seed, device="cpu")
    p["lm_head"] = p["lm_head"] * 6.0
    g = torch.Generator().manual_seed(seed)

    def orth(n):
        q, r = torch.linalg.qr(torch.randn((n, n), generator=g,
                                           dtype=torch.float64))
        return (q * torch.sign(torch.diagonal(r))).float()

    H, I = cfg.hidden_size, cfg.intermediate_size
    transforms = []
    for lp in p["layers"]:
        lt = {"ln_t": tuple(orth(d) for d in get_decompose_dim(H)),
              "ug_t": tuple(orth(d) for d in get_decompose_dim(H)),
              "down_t": tuple(orth(d) for d in get_decompose_dim(I)),
              "o_t": orth(cfg.num_heads), "v_t_inv": orth(128)}
        for key, tr in (("wq", "ln_t"), ("wk", "ln_t"), ("wv", "ln_t"),
                        ("wup", "ug_t"), ("wgate", "ug_t"),
                        ("wdown", "down_t")):
            lp[key] = kron_transform(lp[key], lt[tr])
        lp["wo"] = kron_transform(lp["wo"], (lt["o_t"], torch.eye(128)))
        for key in ("bq", "bk", "bv"):
            lp[key] = torch.randn(lp[key].shape, generator=g) * 0.02
        transforms.append(lt)
    sp = {"embed": p["embed"], "final_norm_w": p["final_norm_w"],
          "lm_head": p["lm_head"],
          "layers": [build_serving_layer(cfg, fq, lp, lt, torch.float32,
                                         merge_projections=True)
                     for lp, lt in zip(p["layers"], transforms)]}
    return cfg, sp


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("w_bits,a_bits", [(4, 16), (8, 8), (4, 8), (8, 16)])
def test_quant_modes_on_the_card_match_the_cpu(cuda, w_bits, a_bits):
    """W4A16 (w4a8_matmul), W8A8 / W4A8 (A8 codes; "w8" through an exact
    int32 product) and W8A16 served on the card with use_kernel=True
    against the same model on the CPU (plain versions), float32 compute,
    a 2 x 300 prefill (600 rows) and 2 decode steps over the bf16 cache.
    The two sides sum in other orders, so a quantizer tie may round apart:
    logits by cosine."""
    from flatquant_torch.quantize.spec import FQConfig
    from flatquant_torch.serving import engine as te

    fq = FQConfig(w_bits=w_bits, a_bits=a_bits, k_bits=16, v_bits=16,
                  lac=False)
    cfg, sp = _small_model(fq)
    toks = torch.randint(0, cfg.vocab_size, (2, 300),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    common.reset_launches()
    for dev in ("cpu", "cuda"):
        spd = _to(sp, dev)
        c = te.init_cache(cfg, 2, 384, dtype=torch.float32, device=dev)
        lg, c = te.serving_prefill(cfg, fq, spd, toks, c, max_len=384,
                                   compute_dtype=torch.float32, device=dev)
        steps = [lg.cpu()]
        for i in range(2):
            tok = steps[-1].argmax(-1, keepdim=True)
            lg, c = te.serving_decode_step(cfg, fq, spd, tok, c, 300 + i,
                                           max_len=384,
                                           compute_dtype=torch.float32,
                                           device=dev)
            steps.append(lg.cpu())
        out[dev] = steps
    if w_bits == 4 and a_bits == 16:
        assert common.LAUNCHES["w4a8_matmul"] == 4 * 2 * 3
    elif w_bits == 4:
        assert common.LAUNCHES["w4a4_matmul_i8"] > 0
    for a, b in zip(out["cpu"], out["cuda"]):
        assert torch.isfinite(b).all()
        cos = torch.nn.functional.cosine_similarity(a, b, dim=-1).min()
        assert cos > 0.99, cos


# ---------------------------------------------------------------------------
# row 16: fp8_matmul
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [True, False])
def test_fp8_matmul_decodes_every_code(cuda, exact):
    """All 254 non-NaN codes through an identity x, float32 out: exact
    decodes each to its IEEE value, FTZ zeroes only the subnormal codes."""
    from flatquant_torch.kernels import fp8_matmul as f8

    codes = torch.arange(256, device=cuda, dtype=torch.int32).repeat(64)
    codes = codes.reshape(128, 128).to(torch.uint8)
    codes[(codes & 0x7F) == 0x7F] = 0
    w8 = codes.view(torch.float8_e4m3fn)
    eye = torch.eye(128, device=cuda).to(torch.bfloat16)
    ones = torch.ones((1, 128), device=cuda)
    got = f8.fp8_matmul(eye, w8, ones, torch.float32, exact)
    want = w8.float().t()
    if not exact:
        sub = (((codes & 0x7F) > 0) & ((codes & 0x7F) < 8)).t()
        want = torch.where(sub, torch.zeros_like(want), want)
    assert torch.equal(got, want)
    assert torch.equal(got, f8.fp8_matmul_ref(eye, w8, ones, torch.float32,
                                              exact))


def _fp8_inputs(cuda, e, m, n, k, seed):
    """x [(E,) M, K] bf16 and a weight [(E,) N, K] packed in 128-blocks
    (a ragged N's last block partial, as DeepSeek-V3's wkv_a)."""
    from flatquant_torch.kernels import fp8_matmul as f8

    g = torch.Generator(device=cuda).manual_seed(seed)
    lead = (e,) if e else ()
    w8, s = f8.fp8_block_quantize(torch.randn(lead + (n, k), generator=g,
                                              device=cuda) * 0.05, 128)
    x = torch.randn(lead + (m, k), generator=g, device=cuda).to(
        torch.bfloat16)
    if e and m == 1:
        x = x[:1].expand(e, m, k)
    return x, w8, f8.expand_fp8_scales(s, n, k)


@pytest.mark.gpu
@pytest.mark.parametrize("e,m,n,k", [(0, 1, 384, 256), (0, 4, 3072, 2048),
                                     (0, 300, 256, 1408), (3, 1, 256, 512),
                                     (3, 70, 384, 256)])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_fp8_matmul_matches_plain(cuda, e, m, n, k, out):
    """The routed body, with and without an expert axis (x shared by the
    experts at M = 1: stride 0), within the fp8 tolerance of
    kernels/tolerance.py."""
    from flatquant_torch.kernels import fp8_matmul as f8
    from flatquant_torch.kernels.tolerance import compare_f32

    x, w8, se = _fp8_inputs(cuda, e, m, n, k, m + n)
    body = f8.fp8_body(m)
    before = common.LAUNCHES["fp8_matmul"]
    by_body = common.BODY_LAUNCHES["fp8_matmul"][body]
    got = f8.fp8_matmul(x, w8, se, out, exact=True)
    assert common.LAUNCHES["fp8_matmul"] == before + 1
    assert common.BODY_LAUNCHES["fp8_matmul"][body] == by_body + 1
    want = f8.fp8_matmul_ref(x, w8, se, out)
    if out == torch.float32:
        compare_f32(got, want, "fp8_matmul")
    else:
        compare_bf16(got, want, "identity", "fp8_matmul")


@pytest.mark.gpu
@pytest.mark.parametrize("body", ["n8", "n64", "n128"])
@pytest.mark.parametrize("m", [1, 4, 64, 65, 384, 2048])
@pytest.mark.parametrize("e", [0, 3])
def test_fp8_matmul_bodies_match_plain(cuda, monkeypatch, body, m, e):
    """Every body at M on both sides of each route edge, with and without
    the expert axis, at a ragged N (576 = 4.5 x 128, DeepSeek's wkv_a),
    within the "identity" tolerance; both decodes on FTZ-packed weights
    (where they agree)."""
    from flatquant_torch.kernels import fp8_matmul as f8

    x, w8, se = _fp8_inputs(cuda, e, m, 576, 384, m + 11 * e)
    monkeypatch.setattr(f8, "fp8_body", lambda m_: body)
    for exact in (True, False):
        got = f8.fp8_matmul(x, w8, se, torch.bfloat16, exact)
        compare_bf16(got, f8.fp8_matmul_ref(x, w8, se, torch.bfloat16,
                                            exact), "identity",
                     f"fp8_matmul {body} M={m} E={e}")


@pytest.mark.gpu
def test_fp8_linear_masks_a_ragged_n_on_the_kernel(cuda, monkeypatch):
    """DeepSeek-V3's wkv_a (N = 576, K = 7168) in 128-blocks takes the
    kernel at N = 576 itself (no pad copy: the kernel masks the ragged N);
    in 64-blocks (prep_fp8_weight's choice for N = 576) fp8_matmul_ref,
    JAX's route."""
    from flatquant_torch.kernels import fp8_matmul as f8

    g = torch.Generator(device=cuda).manual_seed(0)
    w = torch.randn((576, 7168), generator=g, device=cuda) * 0.05
    q, s = f8.fp8_block_quantize(w, 128)
    lin = {"w8": q, "se": f8.expand_fp8_scales(s, 576, 7168)}
    x = torch.randn((3, 7168), generator=g, device=cuda).to(torch.bfloat16)
    seen, kernel = [], f8.fp8_matmul
    monkeypatch.setattr(f8, "fp8_matmul", lambda x_, w_, s_, *a: (
        seen.append((w_.data_ptr(), tuple(w_.shape), tuple(s_.shape)))
        or kernel(x_, w_, s_, *a)))
    before = common.LAUNCHES["fp8_matmul"]
    got = f8.fp8_linear(x, lin, exact=True)
    assert common.LAUNCHES["fp8_matmul"] == before + 1
    assert seen == [(q.data_ptr(), (576, 7168), (56, 576))]
    assert got.shape == (3, 576)
    compare_bf16(got, f8.fp8_matmul_ref(x, q, lin["se"]), "identity",
                 "fp8_linear at N = 576")
    lin64 = f8.prep_fp8_weight(w)
    assert lin64["se"].shape == (112, 576)
    f8.fp8_linear(x, lin64)
    assert common.LAUNCHES["fp8_matmul"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["K % 128", "w8 K", "fp16 x", "se shape"])
def test_fp8_matmul_raises_on_what_it_does_not_take(cuda, what):
    from flatquant_torch.kernels import fp8_matmul as f8

    n, k = {"K % 128": (128, 192)}.get(what, (192, 256))
    w8 = torch.zeros((n, k), device=cuda).to(torch.float8_e4m3fn)
    se = torch.ones((max(k // 128, 1), n), device=cuda)
    x = torch.zeros((2, k), device=cuda,
                    dtype=torch.float16 if what == "fp16 x" else torch.bfloat16)
    if what == "se shape":
        se = torch.ones((k // 64, n), device=cuda)
    if what == "w8 K":
        w8 = torch.zeros((n, k + 128), device=cuda).to(torch.float8_e4m3fn)
    with pytest.raises(ValueError, match="fp8_matmul"):
        f8.fp8_matmul(x, w8, se)


@pytest.mark.gpu
def test_deepseek_fp8_on_the_card_matches_the_plain_path(cuda):
    """mini-deepseek (V2-Lite's routes at small widths) in native FP8,
    float32: the kernel route (10 fp8_matmul launches per forward: wq and
    wo, the shared and the batched routed experts) against use_kernel=False
    on the card, every logits row within 1% of its norm (bf16 roundings of
    the GEMM inputs may move at float32 ties between the two)."""
    from flatquant_torch.models import deepseek as ds

    cfg = ds.DeepSeekConfig(
        name="mini-deepseek", vocab_size=128, dim=256, inter_dim=320,
        moe_inter_dim=256, n_layers=2, n_dense_layers=1, n_heads=2,
        n_routed_experts=8, n_shared_experts=2, n_activated_experts=2,
        kv_lora_rank=128, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128, original_seq_len=64, max_seq_len=256)
    sp = ds.build_ds_fp8_serving_params(
        cfg, ds.init_ds_params(cfg, 0, device=cuda), dtype=torch.float32)
    toks = torch.randint(0, 128, (1, 256), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    kw = dict(mode="serve", compute_dtype=torch.float32, device=cuda)
    before = common.LAUNCHES["fp8_matmul"]
    got = ds.deepseek_forward(cfg, sp, toks, **kw)
    assert common.LAUNCHES["fp8_matmul"] == before + 10
    want = ds.deepseek_forward(cfg, sp, toks, use_kernel=False, **kw)
    rel = ((got - want).abs().amax(-1) / want.norm(dim=-1)).max().item()
    assert rel < 0.01, rel


# ---------------------------------------------------------------------------
# rows 17-21: the JAX package's measured kernel baselines
# ---------------------------------------------------------------------------


def _fusedq_inputs(cuda, m, n, k, dtype, use_clip, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.randn((m, k), generator=g, device=cuda) * 3).to(dtype)
    x[m // 2] = 0
    wp = torch.randint(0, 256, (n, k // 2), generator=g, device=cuda,
                       dtype=torch.uint8)
    sw = torch.rand((n,), generator=g, device=cuda) * 0.05
    clip = ((torch.tensor(0.93, device=cuda), torch.tensor(0.9, device=cuda))
            if use_clip else None)
    return x, wp, sw, clip


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", [(1, 4096, 4096), (4, 1024, 11008),
                                   (40, 384, 512), (300, 256, 1024)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("use_clip", [False, True])
def test_w4a4_matmul_i8_fusedq_bit_exact(cuda, m, n, k, dtype, use_clip):
    """The routed body, bit for bit against the composed route (rows 12
    and 1) and the plain version; counted under its body."""
    x, wp, sw, clip = _fusedq_inputs(cuda, m, n, k, dtype, use_clip, m)
    out = torch.float32 if dtype == torch.float32 else torch.bfloat16
    body = tmm.fusedq_body(m, n, k)
    by_body = common.BODY_LAUNCHES["w4a4_matmul_i8_fusedq"][body]
    got = _launched("w4a4_matmul_i8_fusedq", tmm.w4a4_matmul_i8_fusedq, x,
                    wp, sw, clip, out)
    assert common.BODY_LAUNCHES["w4a4_matmul_i8_fusedq"][body] == by_body + 1
    xq, xs = tmm.quant_acts_i8(x, clip, 7)
    assert torch.equal(got, tmm.w4a4_matmul_i8(xq, xs, wp, sw, out))
    assert torch.equal(got, tmm.w4a4_matmul_i8_fusedq_ref(x, wp, sw, clip,
                                                          out))


@pytest.mark.gpu
@pytest.mark.parametrize("body", ["stream", "tile"])
@pytest.mark.parametrize("m", [1, 4, tmm.TILE_MIN_M - 1, tmm.TILE_MIN_M, 300,
                               2048])
@pytest.mark.parametrize("n,k", [(4096, 4096), (1024, 11008), (384, 2848)])
@pytest.mark.parametrize("dtype,use_clip", [(torch.bfloat16, True),
                                            (torch.float32, False)])
def test_w4a4_matmul_i8_fusedq_bodies_bit_exact(cuda, monkeypatch, body, m, n,
                                                k, dtype, use_clip):
    """Both bodies across the crossover, at a ragged M (300), K = 11008 and
    K % 64 == 32 (2848), bf16 input with clips and f32 input without, bit
    for bit against the composed route (quant_acts_i8 where K % 128 == 0,
    else its plain version, then w4a4_matmul_i8)."""
    x, wp, sw, clip = _fusedq_inputs(cuda, m, n, k, dtype, use_clip, m + k)
    out = torch.float32 if dtype == torch.float32 else torch.bfloat16
    monkeypatch.setattr(tmm, "fusedq_body", lambda m_, n_, k_: body)
    got = tmm.w4a4_matmul_i8_fusedq(x, wp, sw, clip, out)
    quant = tmm.quant_acts_i8 if k % 128 == 0 else tmm.quant_acts_i8_ref
    xq, xs = quant(x, clip, 7)
    assert torch.equal(got, tmm.w4a4_matmul_i8(xq, xs, wp, sw, out))
    # twice: nothing carries over from one launch to the next
    assert torch.equal(tmm.w4a4_matmul_i8_fusedq(x, wp, sw, clip, out), got)


@pytest.mark.gpu
def test_w4a4_matmul_i8_fusedq_shared_memory_limit(cuda):
    # 8 rows of int8 codes must fit the block's shared memory: the launch
    # reports a K past it, launches nothing, and leaves no error behind
    g = torch.Generator(device=cuda).manual_seed(7)
    sw = torch.rand((128,), generator=g, device=cuda) * 0.05
    before = common.LAUNCHES["w4a4_matmul_i8_fusedq"]
    x = torch.randn((2, 32768), generator=g, device=cuda)
    wp = torch.randint(0, 256, (128, 16384), generator=g, device=cuda,
                       dtype=torch.uint8)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        tmm.w4a4_matmul_i8_fusedq(x, wp, sw)
    assert common.LAUNCHES["w4a4_matmul_i8_fusedq"] == before
    x, wp = x[:, :28672].contiguous(), wp[:, :14336].contiguous()
    got = _launched("w4a4_matmul_i8_fusedq", tmm.w4a4_matmul_i8_fusedq, x,
                    wp, sw)
    assert torch.equal(got, tmm.w4a4_matmul_i8_fusedq_ref(x, wp, sw))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["decode_attention_int4_v1",
                                  "decode_attention_int4_wide",
                                  "decode_attention_int4_v3"])
@pytest.mark.parametrize("nh,nkv", [(8, 8), (8, 2), (28, 4)])
def test_decode_baselines_match_plain(cuda, name, nh, nkv):
    g = torch.Generator(device=cuda).manual_seed(nh + nkv)
    B, S = 4, 512
    kp, kpar, vp, vpar = _cache(g, cuda, B, nkv, S)
    q = torch.randn((B, nh, 128), generator=g, device=cuda)
    valid = torch.tensor([0, 1, 200, 512], device=cuda, dtype=torch.int32)
    got = _launched(name, getattr(tkv, name), q, kp, kpar, vp, vpar, valid,
                    0.088)
    want = tkv.decode_attention_ref(q, kp, kpar[..., :1], kpar[..., 1:], vp,
                                    vpar[..., :1], vpar[..., 1:], valid,
                                    0.088)
    # float32 outputs, summed in another order than the plain version
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert bool((got[0] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("pv_i8", [True, False])
@pytest.mark.parametrize("S,nh,nkv,blk_k", [(256, 4, 2, 512),
                                            (384, 4, 4, 512),
                                            (1024, 8, 1, 256),
                                            (1152, 32, 32, 512),
                                            (2048, 28, 4, 512)])
def test_flash_prefill_kt_i8_matches_plain(cuda, pv_i8, S, nh, nkv, blk_k):
    """S = 1152: key blocks shrunk to one 128-key tile, 9 query tiles (an
    odd count for the block's two warpgroups); Qwen-2.5-7B's 28/4 heads."""
    g = torch.Generator(device=cuda).manual_seed(S + nh)
    q, k, v = (torch.randn((1, S, n, 128), generator=g, device=cuda).to(
        torch.bfloat16) for n in (nh, nkv, nkv))
    kt = k.permute(0, 2, 3, 1)  # the strided view the fused route passes
    sm = 0.088
    before = common.LAUNCHES["flash_prefill_attention_kt_i8"]
    got, k8, v8t, sc = tpa._launch_i8(q, kt, v, sm, pv_i8, blk_k)
    assert common.LAUNCHES["flash_prefill_attention_kt_i8"] == before + 1
    k8r, v8r, scr = tpa.quantize_kv_i8_ref(kt, v)
    assert torch.equal(k8, k8r) and torch.equal(sc[..., 0], scr[..., 0])
    if pv_i8:  # V8^T in the key order of the PV product's register A
        assert torch.equal(v8t, tpa.v8t_key_order(v8r))
        assert torch.equal(sc[..., 1], scr[..., 1])
    want = tpa.flash_prefill_attention_kt_i8_ref(q, kt, v, sm, pv_i8, blk_k)
    # the same exp2f on both sides: p, codes and int32 sums are the plain
    # version's, only float32 sums run in another order
    compare_bf16(got, want, "flash", "flash_prefill_attention_kt_i8")
    assert torch.equal(got, tpa.flash_prefill_attention_kt_i8(
        q, kt.contiguous(), v, sm, pv_i8, blk_k))


# ---------------------------------------------------------------------------
# rows 22-27: the grouped-layout kernels, each against its plain version
# and, bit for bit, against its flat twin on the same values
# ---------------------------------------------------------------------------


def _codes(g, cuda, *shape):
    return torch.randint(-8, 8, shape, generator=g, device=cuda,
                         dtype=torch.int8)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("t,h,dtype", [(300, 4096, torch.bfloat16),
                                       (40, 640, torch.float32),
                                       (1, 4096, torch.bfloat16),
                                       (2048, 4096, torch.bfloat16),
                                       (40, 12288, torch.bfloat16)])
def test_rmsnorm_right_grouped_matches_plain_and_twin(cuda, mode, t, h,
                                                      dtype):
    g = torch.Generator(device=cuda).manual_seed(t)
    x = (torch.randn((t, h), generator=g, device=cuda) * 2).to(dtype)
    w = torch.rand((h,), generator=g, device=cuda) + 0.5
    right = _factor(g, cuda, 128, mode)
    got = _launched("rmsnorm_right_grouped", tgm.rmsnorm_right_grouped, x, w,
                    right, 1e-5)
    assert got.shape == (h // 128, t, 128)
    flat = tgm.ungroup_layout(got)
    compare_bf16(flat, tgm.ungroup_layout(
        tgm.rmsnorm_right_grouped_ref(x, w, right, 1e-5)), mode,
        "rmsnorm_right_grouped")
    assert torch.equal(flat, tfp.rmsnorm_right_flat(x, w, right, 1e-5))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("t,grp,clip", [(300, 32, None),
                                        (37, 86, (0.9, 0.95)),
                                        (8, 2, (0.97, 0.9)),
                                        (1000, 86, (0.9, 0.95)),
                                        (2047, 128, None)])
def test_left_quant_i8_grouped_matches_plain_and_twin(cuda, mode, t, grp,
                                                      clip):
    g = torch.Generator(device=cuda).manual_seed(grp)
    x = (torch.randn((t, grp * 128), generator=g, device=cuda) * 3).to(
        torch.bfloat16)
    x[t // 2] = 0  # an all-zero row: scale 1, codes 0
    left_t = _factor(g, cuda, grp, mode)
    if clip is not None:
        clip = tuple(torch.tensor(c, device=cuda) for c in clip)
    xg = tgm.group_layout(x, grp)
    q, s = _launched("left_quant_i8_grouped", tgm.left_quant_i8_grouped,
                     left_t, xg, clip)
    q_ref, s_ref = tgm.left_quant_i8_grouped_ref(left_t, xg, clip)
    compare_codes(q, q_ref, mode, "left_quant_i8_grouped")
    compare_scales(s, s_ref, mode, "left_quant_i8_grouped")
    q_flat, s_flat = tfp.left_quant_i8_flat(left_t, x, clip)
    assert torch.equal(tgm.ungroup_layout(q), q_flat)
    assert torch.equal(s, s_flat)
    assert s[t // 2].item() == 1.0 and not q[:, t // 2].any()


@pytest.mark.gpu
@pytest.mark.parametrize("t,grp,q_max,clip,dtype", [
    (300, 86, 7, (0.9, 0.95), torch.bfloat16),
    (64, 32, 7, None, torch.bfloat16),
    (40, 6, 127, (0.97, 0.9), torch.float32)])
def test_quant_acts_i8_grouped_matches_plain_and_twin(cuda, t, grp, q_max,
                                                      clip, dtype):
    g = torch.Generator(device=cuda).manual_seed(t + grp)
    x = (torch.randn((t, grp * 128), generator=g, device=cuda) * 3).to(dtype)
    x[1] = 0  # a zero row: scale 1, codes 0
    if clip is not None:
        clip = tuple(torch.tensor(c, device=cuda) for c in clip)
    xg = tgm.group_layout(x, grp)
    q, s = _launched("quant_acts_i8_grouped", tgm.quant_acts_i8_grouped, xg,
                     clip, q_max)
    q_ref, s_ref = tgm.quant_acts_i8_grouped_ref(xg, clip, q_max)
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    q_flat, s_flat = tmm.quant_acts_i8(x, clip, q_max)
    assert torch.equal(tgm.ungroup_layout(q), q_flat)
    assert torch.equal(s, s_flat)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,grp", [
    (300, 384, 86), (4, 1024, 32), (40, 256, 5), (1, 576, 22),
    (tmm.TILE_MIN_M - 1, 4096, 86), (tmm.TILE_MIN_M, 576, 22),
    (2048, 12288, 32), (2047, 4096, 86)])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_w4a4_matmul_i8_grouped_bit_exact(cuda, m, n, grp, out):
    g = torch.Generator(device=cuda).manual_seed(m + grp)
    k = grp * 128
    xq = _codes(g, cuda, m, k)
    xs = torch.rand((m, 1), generator=g, device=cuda) + 0.01
    wp = torch.randint(0, 256, (n, k // 2), generator=g, device=cuda,
                       dtype=torch.uint8)
    sw = torch.rand((n,), generator=g, device=cuda) * 0.05
    xg = tgm.group_layout(xq, grp)
    got = _launched("w4a4_matmul_i8_grouped", tgm.w4a4_matmul_i8_grouped, xg,
                    xs, wp, sw, out)
    assert torch.equal(got, tgm.w4a4_matmul_i8_grouped_ref(xg, xs, wp, sw,
                                                           out))
    assert torch.equal(got, tmm.w4a4_matmul_i8(xq, xs, wp, sw, out))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m,gin,nh", [(300, 32, 384), (64, 86, 256),
                                      (200, 4, 512)])
def test_w4a4_swiglu_grouped_matches_plain_and_twin(cuda, mode, m, gin, nh):
    g = torch.Generator(device=cuda).manual_seed(m + gin)
    k = gin * 128
    xq = _codes(g, cuda, m, k)
    xs = torch.rand((m, 1), generator=g, device=cuda) * 0.2 + 0.01
    wp = torch.randint(0, 256, (2 * nh, k // 2), generator=g, device=cuda,
                       dtype=torch.uint8)
    sw = torch.rand((2 * nh,), generator=g, device=cuda) * 0.01 + 1e-3
    right = _factor(g, cuda, 128, mode)
    twin = tfp.w4a4_matmul_i8_swiglu_right(xq, xs, wp, sw, right)
    for name, fn, x in (
            ("w4a4_swiglu_grouped", tgm.w4a4_swiglu_grouped, xq),
            ("w4a4_swiglu_grouped_gx", tgm.w4a4_swiglu_grouped_gx,
             tgm.group_layout(xq, gin))):
        got = _launched(name, fn, x, xs, wp, sw, right)
        assert got.shape == (nh // 128, m, 128)
        flat = tgm.ungroup_layout(got)
        compare_bf16(flat, tgm.ungroup_layout(
            tgm.w4a4_swiglu_grouped_ref(xq, xs, wp, sw, right)), mode, name)
        assert torch.equal(flat, twin), name


@pytest.mark.gpu
def test_grouped_wrappers_raise_on_what_they_do_not_take(cuda):
    x = torch.zeros((4, 64, 100), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="quant_acts_i8_grouped"):
        tgm.quant_acts_i8_grouped(x)
    with pytest.raises(ValueError, match="left_quant_i8_grouped"):
        tgm.left_quant_i8_grouped(torch.eye(4, device=cuda),
                                  x[..., :64].float())


# the build chain on the card against the same chain on the CPU (phase
# 13 (a)'s rule): from the same fp weights and the transforms frozen on
# the card, at most 1e-5 of the nibbles differ, each by one code, and
# every scale is within 2^-22 relative (cuBLAS and the CPU sum the float32
# transforms in other orders, so a code at a float32 tie may flip)
MINI_128 = dict(name="mini-128", vocab_size=128, hidden_size=256,
                intermediate_size=512, num_layers=2, num_heads=2,
                num_kv_heads=2, head_dim=128, seqlen=256)


def _nibble_steps(a, b):
    a, b = a.cpu().to(torch.int16), b.cpu().to(torch.int16)
    return torch.cat([((a & 0xF) - (b & 0xF)).abs().flatten(),
                      ((a >> 4) - (b >> 4)).abs().flatten()])


@pytest.mark.gpu
@pytest.mark.parametrize("layout", [
    dict(merge_projections=True), {},
    dict(merge_projections=True, perm_transforms=True)])
def test_build_chain_on_the_card_matches_the_cpu(cuda, layout):
    import dataclasses

    from flatquant_torch.models.llama import init_params
    from flatquant_torch.quantize.bake import bake_model
    from flatquant_torch.quantize.spec import W4A4KV4
    from flatquant_torch.quantize.state import bake_layer_fq, init_model_fq
    from flatquant_torch.serving.quantized import build_serving_params

    cfg = LlamaConfig(**MINI_128)
    fq = dataclasses.replace(W4A4KV4, tpu_decompose=True)
    params = init_params(cfg, seed=0, device=cuda)
    frozen = [bake_layer_fq(lf) for lf in init_model_fq(cfg, fq, seed=0,
                                                         device=cuda)]
    sp = build_serving_params(cfg, fq, *bake_model(cfg, fq, params, frozen),
                              **layout)
    want = build_serving_params(
        cfg, fq, *bake_model(cfg, fq, _to(params, "cpu"),
                             [_tree_to(lf, "cpu") for lf in frozen]),
        **layout)
    flips = total = 0
    for g, w in zip(sp["layers"], want["layers"]):
        assert set(g) == set(w)
        for key, val in w.items():
            if not isinstance(val, dict):
                continue
            steps = _nibble_steps(g[key]["wp"], val["wp"])
            assert steps.max() <= 1, key
            flips += int((steps > 0).sum())
            total += steps.numel()
            rel = ((g[key]["scale"].cpu() - val["scale"]).abs()
                   / val["scale"].abs()).max().item()
            assert rel <= 2.0 ** -22, (key, rel)
            for a, b in zip(g[key]["a_clip"], val["a_clip"]):
                assert torch.equal(a.cpu(), b), key
    assert flips <= 1e-5 * total, (flips, total)


def _tree_to(tree, dev):
    import dataclasses

    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _tree_to(getattr(tree, f.name), dev)
            for f in dataclasses.fields(tree)})
    return tree.to(dev) if torch.is_tensor(tree) else tree


@pytest.mark.gpu
@pytest.mark.parametrize("layout", [{}, dict(merge_projections=True,
                                             perm_transforms=True)])
def test_unmerged_and_perm_serve_on_the_card_as_on_the_cpu(cuda, layout):
    """mini-128 packed by the port's chain in JAX's default unmerged and
    in the perm layout, served on the card (use_kernel=True, float32
    compute, a 1 x 256 prefill and 2 decode steps over the int4 cache)
    against the same params on the CPU (plain versions): the two sides
    sum in other orders, so logits by cosine, as
    test_quant_modes_on_the_card_match_the_cpu holds them."""
    import dataclasses

    from flatquant_torch.models.llama import init_params
    from flatquant_torch.quantize.bake import bake_model
    from flatquant_torch.quantize.spec import W4A4KV4
    from flatquant_torch.quantize.state import init_model_fq
    from flatquant_torch.serving import engine as te
    from flatquant_torch.serving.quantized import build_serving_params

    cfg = LlamaConfig(**MINI_128)
    fq = dataclasses.replace(W4A4KV4, tpu_decompose=True)
    sp = build_serving_params(cfg, fq, *bake_model(
        cfg, fq, init_params(cfg, seed=0, device="cpu"),
        init_model_fq(cfg, fq, seed=0, device="cpu")), dtype=torch.float32,
        **layout)
    toks = torch.randint(0, cfg.vocab_size, (1, 256),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", cuda):
        spd = _to(sp, dev)
        cache = te.init_cache(cfg, 1, 384, mode="int4", device=dev)
        lg, cache = te.serving_prefill(cfg, fq, spd, toks, cache,
                                       max_len=384,
                                       compute_dtype=torch.float32,
                                       device=dev)
        logits = [lg]
        for i in range(2):
            lg, cache = te.serving_decode_step(
                cfg, fq, spd, lg.argmax(-1, keepdim=True), cache, 256 + i,
                max_len=384, compute_dtype=torch.float32, device=dev)
            logits.append(lg)
        out[str(dev)] = torch.cat([x.cpu() for x in logits])
    cos = torch.nn.functional.cosine_similarity(
        out["cpu"].double().flatten(), out["cuda"].double().flatten(), dim=0)
    assert cos > 0.99, cos
