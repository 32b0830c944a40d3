"""The port's kernel modules against the JAX package, on the CPU.

Inputs are made with numpy from a seed and go through the JAX function
(its Pallas kernel in interpret mode, as the JAX package's own tests run
it) and through the port's wrapper, which on CPU tensors runs the plain
PyTorch version. Integer outputs (codes, packed bytes, the W4A4 GEMM's
exact int32 sums and its epilogue) must match exactly; the attention
output within a stated float32 tolerance.

The CUDA kernels themselves are held against their plain versions on the
card by tests/test_torch_gpu.py and chip_smoke.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from flatquant_tpu.kernels import int4_matmul as jmm
from flatquant_tpu.kernels import kv_cache as jkv
from flatquant_tpu.serving import quantized as jq
from flatquant_torch.kernels import int4_matmul as tmm
from flatquant_torch.kernels import kv_cache as tkv
from flatquant_torch.serving import quantized as tq

torch.set_num_threads(2)


def _t(a):
    """numpy/JAX array -> torch CPU tensor (bf16 widened exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


# ---------------------------------------------------------------------------
# packing and quantization: exact
# ---------------------------------------------------------------------------


def test_pack_weight_planar_exact(rng):
    q = rng.integers(-8, 8, (96, 256)).astype(np.int8)
    want = np.asarray(jmm.pack_weight_planar(jnp.asarray(q)))
    got = tmm.pack_weight_planar(_t(q))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tmm.unpack_weight_planar(got).numpy(), q)


@pytest.mark.parametrize("with_clip", [False, True])
def test_quantize_pack_kv_exact(rng, with_clip):
    t = (rng.standard_normal((2, 24, 3, 128)) * 2.0).astype(np.float32)
    t[0, 0, 0] = 0.0  # a degenerate all-zero head
    clip = (np.float32(0.93), np.float32(0.88)) if with_clip else None
    jclip = None if clip is None else tuple(jnp.asarray(c) for c in clip)
    tclip = None if clip is None else tuple(torch.tensor(c) for c in clip)
    wp, ws, wz = jkv.quantize_pack_kv(jnp.asarray(t), jclip)
    gp, gs, gz = tkv.quantize_pack_kv(_t(t), tclip)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gz.numpy(), np.asarray(wz))
    # the v4 layout conversions round-trip to the token-major layout
    wc, wpar = jkv.pack_kv_transposed(jnp.asarray(t), jclip)
    gc, gpar = tkv.pack_kv_transposed(_t(t), tclip)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gpar.numpy(), np.asarray(wpar))
    tm_codes, tm_params = tkv.pack_kv_token_major(_t(t), tclip)
    pk, sc, zr = tkv.untranspose_kv(gc, gpar)
    np.testing.assert_array_equal(pk.numpy(), tm_codes.numpy())
    np.testing.assert_array_equal(
        torch.cat([sc, zr], -1).numpy(), tm_params.numpy())


@pytest.mark.parametrize("with_clip", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_act_codes_i8_exact(rng, with_clip, dtype):
    x = (rng.standard_normal((40, 512)) * 3.0).astype(np.float32)
    x[3] = 0.0  # all-zero row: scale 1
    xj = jnp.asarray(x, dtype)
    clip = (np.float32(0.97), np.float32(0.9)) if with_clip else None
    jclip = None if clip is None else tuple(jnp.asarray(c) for c in clip)
    tclip = None if clip is None else tuple(torch.tensor(c) for c in clip)
    wq, ws = jq._act_codes_i8(xj, jclip, 7)
    gq, gs = tq._act_codes_i8(_t(xj), tclip, 7)
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


def test_quantize_kv_asym_and_dequantize_exact(rng):
    t = (rng.standard_normal((2, 5, 3, 128)) * 2.0).astype(np.float32)
    t[1, 2, 0] = 0.0
    clip = (np.float32(0.95), np.float32(0.9))
    want = jq.quantize_kv_asym(jnp.asarray(t),
                               tuple(jnp.asarray(c) for c in clip))
    got = tq.quantize_kv_asym(_t(t), tuple(torch.tensor(c) for c in clip))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for dt in ("float32", "bfloat16"):
        w = jq.dequantize_kv(*want, jnp.dtype(dt))
        g = tq.dequantize_kv(*got, getattr(torch, dt))
        np.testing.assert_array_equal(_np(g), np.asarray(w, np.float32))


def test_kron_transform_matches_jax(rng):
    x = rng.standard_normal((6, 2 * 128)).astype(np.float32)
    left = rng.standard_normal((2, 2)).astype(np.float32)
    right = rng.standard_normal((128, 128)).astype(np.float32)
    want = jq.kron_transform(jnp.asarray(x),
                             (jnp.asarray(left), jnp.asarray(right)))
    got = tq.kron_transform(_t(x), (_t(left), _t(right)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)  # float32 summation order
    np.testing.assert_allclose(got.numpy(), x @ np.kron(left, right),
                               rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------------
# w4a4_matmul_i8: exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 8, 40])
@pytest.mark.parametrize("out", ["bfloat16", "float32"])
def test_w4a4_matmul_i8_exact(rng, m, out):
    n, k = 384, 512
    xq = rng.integers(-8, 8, (m, k)).astype(np.int8)
    xs = rng.uniform(0.01, 0.5, (m, 1)).astype(np.float32)
    wp = rng.integers(0, 256, (n, k // 2)).astype(np.uint8)
    sw = rng.uniform(0.001, 0.05, (n,)).astype(np.float32)
    want = jmm.w4a4_matmul_i8(jnp.asarray(xq), jnp.asarray(xs),
                              jnp.asarray(wp), jnp.asarray(sw),
                              jnp.dtype(out), interpret=True)
    got = tmm.w4a4_matmul_i8(_t(xq), _t(xs), _t(wp), _t(sw),
                             getattr(torch, out))
    assert got.dtype == getattr(torch, out)
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# decode attention: JAX v4 kernel (interpret) vs the port, token-major
# ---------------------------------------------------------------------------


def _packed_cache(rng, B, S, nkv, hd):
    k = (rng.standard_normal((B, S, nkv, hd)) * 1.5).astype(np.float32)
    v = rng.standard_normal((B, S, nkv, hd)).astype(np.float32)
    kc, kpar = jkv.pack_kv_transposed(jnp.asarray(k))
    vc, vpar = jkv.pack_kv_transposed(jnp.asarray(v))
    return kc, kpar, vc, vpar


@pytest.mark.parametrize("nh,nkv", [(4, 4), (8, 2)])
def test_decode_attention_matches_jax_v4(rng, nh, nkv):
    B, S, hd = 3, 256, 128
    kc, kpar, vc, vpar = _packed_cache(rng, B, S, nkv, hd)
    q = rng.standard_normal((B, nh, hd)).astype(np.float32)
    valid = np.array([0, 77, 256], np.int32)
    sm = 1.0 / np.sqrt(hd)
    want = jkv.decode_attention_int4_v4(
        jnp.asarray(q), kc, kpar, vc, vpar, jnp.asarray(valid), sm,
        interpret=True)
    kp, ks, kz = tkv.untranspose_kv(_t(kc), _t(kpar))
    vp, vs, vz = tkv.untranspose_kv(_t(vc), _t(vpar))
    kparam, vparam = torch.cat([ks, kz], -1), torch.cat([vs, vz], -1)
    got = tkv.decode_attention_int4(_t(q), kp, kparam, vp, vparam,
                                    _t(valid), sm)
    # float32: the JAX kernel folds scale/zero into its epilogues and sums
    # in another order than the plain dequant-then-softmax version; both
    # agree to a few float32 ulps of outputs of size ~1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-6)
    assert np.all(got.numpy()[0] == 0.0)  # valid_len 0 -> 0
    ref = tkv.decode_attention_ref(_t(q), kp, ks, kz, vp, vs, vz,
                                   _t(valid), sm)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


# ---------------------------------------------------------------------------
# write_token: JAX write_token_v4 (interpret) vs the port, exact
# ---------------------------------------------------------------------------


def test_write_token_matches_jax_v4(rng):
    B, nkv, hd, L = 4, 2, 128, 256
    kp = rng.integers(0, 256, (B, nkv, hd // 2, L)).astype(np.uint8)
    vp = rng.integers(0, 256, (B, nkv, hd // 2, L)).astype(np.uint8)
    kparam = rng.standard_normal((B, nkv, 2, L)).astype(np.float32)
    vparam = rng.standard_normal((B, nkv, 2, L)).astype(np.float32)
    kq = rng.integers(0, 256, (B, nkv, hd // 2, 1)).astype(np.uint8)
    vq = rng.integers(0, 256, (B, nkv, hd // 2, 1)).astype(np.uint8)
    kpn = rng.standard_normal((B, nkv, 2, 1)).astype(np.float32)
    vpn = rng.standard_normal((B, nkv, 2, 1)).astype(np.float32)
    pos = np.array([3, 130, 255, 0], np.int32)
    want = jkv.write_token_v4(*(jnp.asarray(a) for a in (
        kp, kparam, vp, vparam, kq, kpn, vq, vpn, pos)), interpret=True)

    tm = lambda a: _t(a).transpose(2, 3).contiguous()  # v4 -> token-major
    cache = [tm(a) for a in (kp, kparam, vp, vparam)]
    ptrs = [c.data_ptr() for c in cache]
    out = tkv.write_token(*cache, tm(kq), tm(kpn), tm(vq), tm(vpn), _t(pos))
    assert [c.data_ptr() for c in out] == ptrs  # written in place
    for w, g in zip(want, cache):
        np.testing.assert_array_equal(g.numpy(), tm(np.asarray(w)).numpy())


@pytest.mark.parametrize("B,nkv,hd,pos", [
    (1, 4, 128, [130]),  # Qwen's GQA 28/4 at B = 1
    (4, 2, 128, [0, 255, 256, -1]),  # positions 0, S - 1, S and -1
    (3, 2, 72, [0, 77, 255]),  # 36-byte code rows, not a multiple of 16
])
def test_write_token_cases_match_jax_v4(rng, B, nkv, hd, pos):
    """Each in-range slot lands where JAX's write_token_v4 (interpret) puts
    it, byte for byte; a slot whose position lies outside [0, S) keeps its
    cache. JAX's kernel takes in-range positions only, so it writes the
    in-range slots alone."""
    L = 256
    u8 = lambda *sh: rng.integers(0, 256, sh).astype(np.uint8)
    f32 = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    kp, vp = u8(B, nkv, hd // 2, L), u8(B, nkv, hd // 2, L)
    kparam, vparam = f32(B, nkv, 2, L), f32(B, nkv, 2, L)
    new = (u8(B, nkv, hd // 2, 1), f32(B, nkv, 2, 1),
           u8(B, nkv, hd // 2, 1), f32(B, nkv, 2, 1))
    pos = np.array(pos, np.int32)
    hit = (pos >= 0) & (pos < L)
    want = jkv.write_token_v4(*(jnp.asarray(a[hit]) for a in (
        kp, kparam, vp, vparam, *new, pos)), interpret=True)

    tm = lambda a: _t(a).transpose(2, 3).contiguous()  # v4 -> token-major
    cache = [tm(a) for a in (kp, kparam, vp, vparam)]
    before = [c.clone() for c in cache]
    tkv.write_token(*cache, *(tm(a) for a in new), _t(pos))
    for w, g, b in zip(want, cache, before):
        np.testing.assert_array_equal(g[hit].numpy(),
                                      tm(np.asarray(w)).numpy())
        assert torch.equal(g[~hit], b[~hit])


def test_write_token_out_of_range_writes_nothing(rng):
    B, nkv, S, hdh = 2, 2, 16, 64
    kp = torch.from_numpy(rng.integers(0, 256, (B, nkv, S, hdh), np.uint8))
    kpar = torch.from_numpy(rng.standard_normal((B, nkv, S, 2), np.float32))
    before = kp.clone(), kpar.clone()
    new_c = torch.zeros((B, nkv, 1, hdh), dtype=torch.uint8)
    new_p = torch.zeros((B, nkv, 1, 2))
    tkv.write_token(kp, kpar, kp.clone(), kpar.clone(), new_c, new_p,
                    new_c, new_p, torch.tensor([S, -1]))
    assert torch.equal(kp, before[0]) and torch.equal(kpar, before[1])
