"""The port's Hadamard module (core/hadamard.py), the fused transform +
quant composition (kernels/fused_trans_quant.py), the QuaRot serving
builder and the serving registry against the JAX package, on the CPU.

Tolerances, and why:
  - Hadamard factors (every order the registry's models need through
    get_hadK, their head counts and head dims, the orders the reference
    hardcodes, one random-orthogonal fallback order): equal exactly, both
    built on the host in float64 numpy by the same construction.
  - fwht: exactly (the same adds in the same order); matmul_hadU,
    random_hadamard_matrix: 1e-6 relative (the K x K einsum sums in
    another order in XLA and torch).
  - QuaRot serving params (tiny-llama in float32, mini-128 in bf16): the
    factors, norms and biases exactly (each factor rounded once from
    float64), the codes equal (measured: no code of 92,160 / 1,310,720
    apart; a code may differ only at a rounding tie of the float32 folds,
    and the count is asserted at zero because none exists here), the
    scales within 1e-6 relative (measured 2.4e-7 / 3.4e-7).
  - The route: JAX's and the port's kernel calls counted with the
    kernels' module attributes wrapped; both take w4a4_matmul_i8 and no
    fused prefill kernel (the pairs' right factors are not 128 and q, k,
    v are unpacked), and the port's logits equal its plain run exactly.
  - fused_kron_quant / fused_head_trans_quant: codes equal, scales within
    1e-6 relative (float32 products summed in another order).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flatquant_tpu.core import hadamard as jh
from flatquant_tpu.kernels import fused_trans_quant as jftq
from flatquant_tpu.models.config import LlamaConfig as JLlamaConfig
from flatquant_tpu.models.config import get_config as j_get_config
from flatquant_tpu.models.llama import init_params as j_init_params
from flatquant_tpu.quantize.spec import W4A4KV4 as J_W4A4KV4
from flatquant_tpu.serving import quantized as jq
from flatquant_tpu.serving import registry as jreg
from flatquant_torch.core import hadamard as th
from flatquant_torch.kernels import fused_trans_quant as tftq
from flatquant_torch.kernels.int4_matmul import unpack_weight_planar
from flatquant_torch.models.config import LlamaConfig
from flatquant_torch.models.config import get_config, list_configs
from flatquant_torch.quantize.spec import W4A4KV4
from flatquant_torch.serving import quantized as tq
from flatquant_torch.serving import registry as treg
from flatquant_torch.utils.convert import (
    from_jax_params,
    from_jax_serving_params,
)

torch.set_num_threads(2)

MINI = dict(name="mini-128", vocab_size=128, hidden_size=256,
            intermediate_size=512, num_layers=2, num_heads=2,
            num_kv_heads=2, head_dim=128, seqlen=256)
REF_ORDERS = (12, 20, 28, 36, 40, 44, 52, 60, 108, 140, 156, 172)
FALLBACK_ORDER = 92  # 4 * 23: no Paley, no table, 46 not constructible


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _model_widths():
    """Every width a registry model rotates: hidden, intermediate (through
    get_hadK), heads and head_dim (hadamard_matrix)."""
    cfgs = [get_config(n) for n in list_configs()]
    return (sorted({w for c in cfgs for w in (c.hidden_size,
                                              c.intermediate_size)}
                   | {4096, 11008, 13824, 14336, 5120, 8192, 28672}),
            sorted({w for c in cfgs for w in (c.num_heads, c.head_dim)}))


@pytest.mark.parametrize("n", _model_widths()[0])
def test_get_hadK_equal_for_model_widths(n):
    jm, jk, jhad = jh.get_hadK(n)
    tm, tk, thad = th.get_hadK(n)
    assert (tk, thad) == (jk, jhad)
    assert (tm is None) == (jm is None)
    if jm is not None:
        assert tm.dtype == jm.dtype and np.array_equal(tm, jm)


@pytest.mark.parametrize("k", REF_ORDERS + tuple(_model_widths()[1])
                         + (FALLBACK_ORDER,))
def test_hadamard_matrix_equal(k):
    jm, jhad = jh.hadamard_matrix(k)
    tm, thad = th.hadamard_matrix(k)
    assert thad == jhad
    assert tm.dtype == jm.dtype and np.array_equal(tm, jm)
    if k in REF_ORDERS:
        assert thad and np.array_equal(tm @ tm.T, k * np.eye(k))
    if k == FALLBACK_ORDER:
        assert not thad
        np.testing.assert_allclose(tm @ tm.T, k * np.eye(k), atol=1e-9)


@pytest.mark.parametrize("n", [64, 688, 864])
def test_fwht_and_matmul_hadU_match_jax(n):
    x = np.random.default_rng(n).standard_normal((5, n)).astype(np.float32)
    p = 1 << (n.bit_length() - 1)
    if p == n:
        np.testing.assert_array_equal(th.fwht(torch.as_tensor(x)).numpy(),
                                      np.asarray(jh.fwht(jnp.asarray(x))))
    got = th.matmul_hadU(torch.as_tensor(x)).numpy()
    want = np.asarray(jax.jit(jh.matmul_hadU)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(
        want).max())
    np.testing.assert_allclose(
        th.apply_had_to_weight(torch.as_tensor(x)).numpy(), want,
        rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_random_hadamard_matrix_matches_jax():
    got = th.random_hadamard_matrix(64, seed=3, device="cpu").numpy()
    want = np.asarray(jh.random_hadamard_matrix(64, seed=3))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got @ got.T, np.eye(64), atol=1e-5)


@pytest.mark.parametrize("clipped", [False, True])
def test_fused_kron_quant_matches_jax(clipped):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 48)).astype(np.float32)
    left = rng.standard_normal((6, 6)).astype(np.float32)
    right = rng.standard_normal((8, 8)).astype(np.float32)
    diag = (rng.random(48) + 0.5).astype(np.float32)
    clip = (np.float32(0.9), np.float32(0.8)) if clipped else (None, None)
    jc, js = jax.jit(jftq.fused_kron_quant)(
        jnp.asarray(x), jnp.asarray(left), jnp.asarray(right),
        jnp.asarray(diag), *clip)
    tc, ts = tftq.fused_kron_quant(torch.as_tensor(x), torch.as_tensor(left),
                                   torch.as_tensor(right),
                                   torch.as_tensor(diag), *clip)
    assert tc.dtype == torch.bfloat16
    np.testing.assert_array_equal(tc.float().numpy(),
                                  np.asarray(jc, np.float32))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)

    xh = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    hm = rng.standard_normal((4, 4)).astype(np.float32)
    jc, js = jax.jit(jftq.fused_head_trans_quant)(jnp.asarray(xh),
                                                  jnp.asarray(hm))
    tc, ts = tftq.fused_head_trans_quant(torch.as_tensor(xh),
                                         torch.as_tensor(hm))
    np.testing.assert_array_equal(tc.float().numpy(),
                                  np.asarray(jc, np.float32))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


# ---------------------------------------------------------------------------
# QuaRot serving and the registry
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quarot():
    """tiny-llama (float32) and mini-128 (bf16): JAX's random weights in
    both packages and JAX's QuaRot build."""
    out = {}
    for key, jcfg, cfg, jdt, tdt in (
            ("tiny-llama", j_get_config("tiny-llama"),
             get_config("tiny-llama"), jnp.float32, torch.float32),
            ("mini-128", JLlamaConfig(**MINI), LlamaConfig(**MINI),
             jnp.bfloat16, torch.bfloat16)):
        jp = j_init_params(jcfg, seed=0)
        jsp = jax.jit(lambda p, c=jcfg, d=jdt: jreg.get_serving_builder(
            "LlamaQuaRotForCausalLM")(c, J_W4A4KV4, p, dtype=d))(jp)
        out[key] = dict(jcfg=jcfg, cfg=cfg, jp=jp, jsp=jsp, jdt=jdt,
                        tdt=tdt, tp=from_jax_params(_np(jp), "cpu"),
                        want=from_jax_serving_params(_np(jsp), "cpu"))
    return out


@pytest.mark.parametrize("model", ["tiny-llama", "mini-128"])
def test_quarot_serving_params_match_jax(quarot, model):
    m = quarot[model]
    got = tq.build_hadamard_serving_params(m["cfg"], W4A4KV4, m["tp"],
                                           dtype=m["tdt"])
    flips = total = 0
    worst = 0.0
    for key in ("embed", "final_norm_w", "lm_head"):
        assert got[key].dtype == m["want"][key].dtype
        assert torch.equal(got[key], m["want"][key]), key
    for g, w in zip(got["layers"], m["want"]["layers"]):
        assert set(g) == set(w), set(g) ^ set(w)
        assert "qkv" not in g and "upgate" not in g
        for key, val in w.items():
            if isinstance(val, dict):
                cg = unpack_weight_planar(g[key]["wp"])
                cw = unpack_weight_planar(val["wp"])
                flips += int((cg != cw).sum())
                total += cg.numel()
                rel = ((g[key]["scale"] - val["scale"]).abs()
                       / val["scale"]).max().item()
                worst = max(worst, rel)
            else:
                pair = val if isinstance(val, tuple) else (val,)
                mine = g[key] if isinstance(val, tuple) else (g[key],)
                for a, b in zip(mine, pair):
                    assert a.dtype == b.dtype and torch.equal(a, b), key
    assert flips == 0, f"{flips} of {total} codes differ"
    assert worst <= 1e-6, worst


def test_hadamard_pair_rounds_once_from_float64():
    """bf16 factors rounded once from float64 (jnp.asarray's cast); the
    ln pair of llama-2-7b is (64, 64), its down pair (172, 64)."""
    for n, shapes in ((4096, (64, 64)), (11008, (172, 64))):
        got = tq.hadamard_pair(n, torch.bfloat16, "cpu")
        want = jq.hadamard_pair(n, jnp.bfloat16)
        assert tuple(a.shape[0] for a in got) == shapes
        for a, b in zip(got, want):
            assert torch.equal(a.float(), torch.as_tensor(
                np.asarray(b, np.float32)))


def _count(module, names, calls, monkeypatch):
    for name in names:
        orig = getattr(module, name)

        def counted(*a, _n=name, _f=orig, **k):
            calls[_n] = calls.get(_n, 0) + 1
            return _f(*a, **k)

        monkeypatch.setattr(module, name, counted)


FUSED = ("rmsnorm_right_flat", "left_quant_i8_flat",
         "w4a4_matmul_i8_swiglu_right")


def test_quarot_route_matches_jax(quarot, monkeypatch):
    """mini-128 QuaRot, a 1 x 264 prefill with use_kernel in both
    packages: JAX's calls (its kernel module attributes wrapped; traced
    once for the scanned layers) and the port's take w4a4_matmul_i8 and
    none of the fused prefill kernels (attn_prologue, the flat pipeline),
    as both decline the unmerged layout and the 16 x 16 ln pair."""
    from flatquant_tpu.kernels import attn_prologue as jap
    from flatquant_tpu.kernels import flat_pipeline as jfp
    from flatquant_tpu.serving import engine as je
    from flatquant_torch.kernels import flat_pipeline as tfp
    from flatquant_torch.serving import engine as te

    m = quarot["mini-128"]
    cfg, jcfg = m["cfg"], m["jcfg"]
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 264))
    jcalls, tcalls = {}, {}
    _count(jfp, FUSED, jcalls, monkeypatch)
    _count(jap, ("attn_prologue",), jcalls, monkeypatch)
    _count(jq, ("w4a4_matmul_i8", "quant_acts_i8"), jcalls, monkeypatch)
    _count(tfp, FUSED, tcalls, monkeypatch)
    _count(tq, FUSED + ("w4a4_matmul_i8", "quant_acts_i8"), tcalls,
           monkeypatch)
    _count(te, ("attn_prologue", "left_quant_i8_flat"), tcalls, monkeypatch)
    jsp32 = jax.jit(lambda p: jq.build_hadamard_serving_params(
        jcfg, J_W4A4KV4, p, dtype=jnp.float32))(m["jp"])
    je.serving_prefill(jcfg, J_W4A4KV4, jsp32, jnp.asarray(toks),
                       je.init_cache(jcfg, 1, 384, mode="int4"),
                       use_kernel=True, max_len=384,
                       compute_dtype=jnp.float32)
    tsp = tq.build_hadamard_serving_params(cfg, W4A4KV4, m["tp"],
                                           dtype=torch.float32)
    run = [te.serving_prefill(cfg, W4A4KV4, tsp, toks, te.init_cache(
        cfg, 1, 384, mode="int4", device="cpu"), use_kernel=uk, max_len=384,
        compute_dtype=torch.float32, device="cpu")[0] for uk in (True,
                                                                  False)]
    assert set(jcalls) == {"w4a4_matmul_i8"}, jcalls
    assert tcalls == {"w4a4_matmul_i8": 7 * cfg.num_layers}, tcalls
    assert torch.equal(run[0], run[1])


def test_registry_matches_jax_and_each_builder(quarot):
    """The five architectures JAX registers; each port builder the same
    params as its builder called directly; unknown names raise."""
    from flatquant_torch.quantize.bake import bake_model
    from flatquant_torch.quantize.state import init_model_fq

    assert treg.list_archs() == jreg.list_archs()
    with pytest.raises(KeyError):
        treg.get_serving_builder("NopeForCausalLM")
    m = quarot["tiny-llama"]
    cfg = m["cfg"]
    bp, bf = bake_model(cfg, W4A4KV4, m["tp"],
                        init_model_fq(cfg, W4A4KV4, seed=0, device="cpu"))
    direct = {
        "flat": tq.build_serving_params(cfg, W4A4KV4, bp, bf),
        "had": tq.build_hadamard_serving_params(cfg, W4A4KV4, m["tp"])}
    for arch in treg.list_archs():
        build = treg.get_serving_builder(arch)
        kind = "had" if "QuaRot" in arch else "flat"
        got = (build(cfg, W4A4KV4, m["tp"]) if kind == "had"
               else build(cfg, W4A4KV4, bp, bf))
        want = direct[kind]
        for g, w in zip(got["layers"], want["layers"]):
            assert set(g) == set(w)
            for key in ("q", "k", "v", "o", "up", "gate", "down"):
                assert torch.equal(g[key]["wp"], w[key]["wp"]), (arch, key)
                assert torch.equal(g[key]["scale"], w[key]["scale"])
