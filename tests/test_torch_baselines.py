"""The JAX package's measured kernel baselines against the port, on the CPU.

Rows 17-21 of the kernel table (PERF.md): the fused-quant GEMM
(w4a4_matmul_i8_fusedq), the int8 flash prefill
(flash_prefill_attention_kt_i8) and the three token-major decode
attentions (JAX's decode_attention_int4, _wide and _v3; the port's
decode_attention_int4_v1, _wide and _v3). Inputs are made with numpy from
a seed and go through JAX's Pallas kernel in interpret mode and through
the port's wrapper, which on CPU tensors runs its plain version.

Tolerances, and why:
  - row 17: bit for bit. With JAX's power-of-two-scale construction
    (tests/test_kernels.py:104-140) against JAX's fused kernel; on general
    inputs against JAX's composed route (the quant as eager jnp, then
    w4a4_matmul_i8). JAX's fused kernel in interpret mode divides absmax by
    7 as a multiplication by the reciprocal: it differs from both exactly
    in the rows where that product is one float32 ulp off the quotient.
  - rows 19-21: float32 within 1e-5 (the sums run in another order; v3
    folds scale and zero into the epilogues, where q.c and sum(q) * z
    cancel); a slot with valid_len 0 gives exactly 0.
  - row 18: the int8 codes of K, V and q and the two scales per head equal
    JAX's (its kernel's expressions, op by op); the output within
    kernels/tolerance.py's compare_flash_i8 (the "flash" bound plus one
    int8 code of V): XLA's exp2 and torch's differ by an ulp on most
    inputs on the CPU, which moves p (and a p * 127 at a rounding tie to
    the other code). Both stay within JAX's own rel-RMS
    bounds against the float32 oracle (tests/test_prefill_attention.py:
    0.035 with pv_i8, 0.02 without).

The CUDA kernels are held against these plain versions on the card by
tests/test_torch_gpu.py and chip_smoke.py (phases 3i and 11).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from flatquant_tpu.kernels import int4_matmul as jmm
from flatquant_tpu.kernels import kv_cache as jkv
from flatquant_tpu.kernels import prefill_attention as jpa
from flatquant_torch.kernels import common
from flatquant_torch.kernels import int4_matmul as tmm
from flatquant_torch.kernels import kv_cache as tkv
from flatquant_torch.kernels import prefill_attention as tpa
from flatquant_torch.kernels.tolerance import compare_flash_i8

torch.set_num_threads(2)

_LOG2E = 1.4426950408889634


def _t(a):
    """numpy/JAX array -> torch CPU tensor (bf16 kept as bf16)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# row 17: w4a4_matmul_i8_fusedq
# ---------------------------------------------------------------------------


def _weights(rng, n, k):
    q = rng.integers(-8, 8, (n, k)).astype(np.int8)
    wp = np.asarray(jmm.pack_weight_planar(jnp.asarray(q)))
    ws = rng.uniform(0.005, 0.02, (n,)).astype(np.float32)
    return wp, ws


@pytest.mark.parametrize("use_clip", [False, True])
def test_fusedq_bit_exact_with_power_of_two_scales(rng, use_clip):
    """JAX's construction: every row's absmax is 7 * 2^-1, so the scale is a
    power of two and the division by 7 is exact in any lowering."""
    m, k, n = 64, 256, 384
    wp, ws = _weights(rng, n, k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    idx = np.argmax(np.abs(x), axis=1)
    x[np.arange(m), idx] = np.sign(x[np.arange(m), idx]) * 7.0 * 0.5
    x = np.clip(x, -7.0 * 0.5, 7.0 * 0.5)
    jclip = (jnp.float32(1.0), jnp.float32(1.0)) if use_clip else None
    tclip = (torch.tensor(1.0), torch.tensor(1.0)) if use_clip else None
    want = jmm.w4a4_matmul_i8_fusedq(jnp.asarray(x), jnp.asarray(wp),
                                     jnp.asarray(ws), jclip, jnp.float32,
                                     block_m=64, block_n=128, interpret=True)
    before = common.LAUNCHES["w4a4_matmul_i8_fusedq"]
    got = tmm.w4a4_matmul_i8_fusedq(_t(x), _t(wp), _t(ws), tclip,
                                    torch.float32)
    assert common.LAUNCHES["w4a4_matmul_i8_fusedq"] == before  # plain route
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_clip", [False, True])
def test_fusedq_general_inputs_equal_the_composed_route(rng, dtype,
                                                        use_clip):
    m, k, n = 48, 384, 256
    wp, ws = _weights(rng, n, k)
    x = jnp.asarray(rng.standard_normal((m, k)) * 2.0, getattr(jnp, dtype))
    x = x.at[5].set(0)  # a zero row: scale 1, codes 0
    clip = (np.float32(0.91), np.float32(0.87)) if use_clip else None
    jclip = None if clip is None else tuple(jnp.asarray(c) for c in clip)
    tclip = None if clip is None else tuple(torch.tensor(c) for c in clip)
    got = tmm.w4a4_matmul_i8_fusedq(_t(x), _t(wp), _t(ws), tclip,
                                    torch.float32).numpy()

    # JAX's composed route: the kernel's scale rule as eager jnp, then
    # w4a4_matmul_i8 in interpret mode
    xf = x.astype(jnp.float32)
    xmax = jnp.maximum(jnp.max(xf, axis=1, keepdims=True), 0.0)
    xmin = jnp.minimum(jnp.min(xf, axis=1, keepdims=True), 0.0)
    if jclip is not None:
        xmax, xmin = xmax * jclip[0], xmin * jclip[1]
    absmax = jnp.maximum(jnp.abs(xmin), xmax)
    xs = jnp.where(absmax == 0, 1.0, absmax / 7.0)
    xq = jnp.clip(jnp.round(xf / xs), -8, 7).astype(jnp.int8)
    composed = jmm.w4a4_matmul_i8(xq, xs, jnp.asarray(wp), jnp.asarray(ws),
                                  jnp.float32, block_m=48, block_n=128,
                                  interpret=True)
    np.testing.assert_array_equal(got, np.asarray(composed))
    # the port's own composed route, quant_acts_i8 then w4a4_matmul_i8
    tq, ts = tmm.quant_acts_i8(_t(x), tclip, 7)
    np.testing.assert_array_equal(
        got, tmm.w4a4_matmul_i8(tq, ts, _t(wp), _t(ws), torch.float32).numpy())

    # JAX's fused kernel: equal but in the rows where its absmax * (1/7)
    # lands one float32 ulp off absmax / 7
    fused = np.asarray(jmm.w4a4_matmul_i8_fusedq(
        x, jnp.asarray(wp), jnp.asarray(ws), jclip, jnp.float32,
        block_m=48, block_n=128, interpret=True))
    am = np.asarray(absmax)[:, 0]
    recip = (am * (np.float32(1.0) / np.float32(7.0))).astype(np.float32)
    ulp_off = set(np.where((recip != am / np.float32(7.0)) & (am > 0))[0])
    assert set(np.where((fused != got).any(axis=1))[0]) == ulp_off


# ---------------------------------------------------------------------------
# rows 19-21: the token-major decode attentions
# ---------------------------------------------------------------------------

DECODE = {"decode_attention_int4_v1": "decode_attention_int4",
          "decode_attention_int4_wide": "decode_attention_int4_wide",
          "decode_attention_int4_v3": "decode_attention_int4_v3"}


@pytest.mark.parametrize("port_name", list(DECODE))
@pytest.mark.parametrize("shape", [(2, 256, 2, 8, 64), (1, 128, 4, 4, 128)])
def test_decode_baselines_match_jax(rng, shape, port_name):
    B, S, nkv, nh, hd = shape
    k = rng.standard_normal((B, nkv, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, nkv, S, hd)).astype(np.float32)
    kp, ks, kz = jkv.quantize_pack_kv(jnp.asarray(k))
    vp, vs, vz = jkv.quantize_pack_kv(jnp.asarray(v))
    kpar = jnp.concatenate([ks, kz], -1)
    vpar = jnp.concatenate([vs, vz], -1)
    q = rng.standard_normal((B, nh, hd)).astype(np.float32)
    jfn, tfn = getattr(jkv, DECODE[port_name]), getattr(tkv, port_name)
    for valid in ([0, 1], [1, S - 3]) if B == 2 else ([0], [1], [S - 5]):
        valid = np.asarray(valid, np.int32)
        want = np.asarray(jfn(jnp.asarray(q), kp, kpar, vp, vpar,
                              jnp.asarray(valid), 0.125, block_s=64,
                              interpret=True))
        got = tfn(_t(q), _t(kp), _t(kpar), _t(vp), _t(vpar), _t(valid),
                  0.125).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert not got[valid == 0].any()


# ---------------------------------------------------------------------------
# row 18: flash_prefill_attention_kt_i8
# ---------------------------------------------------------------------------


def _flash_inputs(rng, S, nh, nkv, hd=128):
    q = jnp.asarray(rng.standard_normal((1, S, nh, hd)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((1, S, nkv, hd)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((1, S, nkv, hd)), jnp.bfloat16)
    return q, jnp.transpose(k, (0, 2, 3, 1)), v


def test_flash_i8_codes_and_scales_equal_jax(rng):
    """K, V and q codes and the per-head scales against the Pallas body's
    expressions (prefill_attention.py:304-334), op by op."""
    S, nh, nkv, hd = 512, 4, 2, 128
    q, kt, v = _flash_inputs(rng, S, nh, nkv)
    sm = 1.0 / np.sqrt(hd)
    k8, v8t, sc = tpa.quantize_kv_i8_ref(_t(kt), _t(v))
    q8, qa = tpa.quantize_q_i8_ref(_t(q), sm)
    for h in range(nkv):
        ktf = kt[0, h].astype(jnp.float32)  # [hd, S]
        ks = jnp.maximum(jnp.max(jnp.abs(ktf)), 1e-30)
        ki8 = jnp.clip(jnp.round(ktf.T * (127.0 / ks)), -127, 127)
        vf = v[0, :, h].astype(jnp.float32)  # [S, hd]
        vs = jnp.maximum(jnp.max(jnp.abs(vf)), 1e-30)
        vi8 = jnp.clip(jnp.round(vf.T * (127.0 / vs)), -127, 127)
        np.testing.assert_array_equal(k8[0, h].numpy(), np.asarray(ki8))
        np.testing.assert_array_equal(v8t[0, h].numpy(), np.asarray(vi8))
        assert sc[0, h, 0].item() == float(ks / 127.0)
        assert sc[0, h, 1].item() == float(vs / (127.0 * 127.0))
    for r in range(nh):
        qf = q[0, :, r].astype(jnp.float32) * (sm * _LOG2E)
        q_amax = jnp.maximum(jnp.max(jnp.abs(qf), axis=1, keepdims=True),
                             1e-30)
        qi8 = jnp.clip(jnp.round(qf * (127.0 / q_amax)), -127, 127)
        np.testing.assert_array_equal(q8[0, :, r].numpy(), np.asarray(qi8))
        np.testing.assert_array_equal(qa[0, :, r].numpy(),
                                      np.asarray(q_amax))


@pytest.mark.parametrize("pv_i8,bound", [(True, 0.035), (False, 0.02)])
@pytest.mark.parametrize("S,blk_k", [(512, 512), (384, 512), (512, 128)])
def test_flash_i8_matches_jax(rng, S, blk_k, pv_i8, bound):
    """S = 512 with 4/2 heads, and the key block shrunk to a divisor of S
    (384 -> 128) or chosen smaller (128: four blocks, p rounded against
    each block's running max)."""
    nh, nkv, hd = 4, 2, 128
    q, kt, v = _flash_inputs(rng, S, nh, nkv)
    sm = 1.0 / np.sqrt(hd)
    want = jpa.flash_prefill_attention_kt_i8(q, kt, v, sm, blk_k=blk_k,
                                             pv_i8=pv_i8, interpret=True)
    got = tpa.flash_prefill_attention_kt_i8(_t(q), _t(kt), _t(v), sm,
                                            pv_i8=pv_i8, blk_k=blk_k)
    assert got.dtype == torch.bfloat16 and got.shape == (1, S, nh, hd)
    compare_flash_i8(got, _t(want), _t(v), f"kt_i8 S={S} pv_i8={pv_i8}")
    oracle = np.asarray(jpa.flash_prefill_ref(
        q.astype(jnp.float32), jnp.transpose(kt, (0, 3, 1, 2)).astype(
            jnp.float32), v.astype(jnp.float32), sm))
    for out in (got.float().numpy(), np.asarray(want, np.float32)):
        rel_rms = np.sqrt(((out - oracle) ** 2).mean() / (oracle ** 2).mean())
        assert rel_rms < bound, rel_rms
