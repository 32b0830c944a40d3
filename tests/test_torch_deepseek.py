"""DeepSeek serving of the port against the JAX package, on the CPU.

The same numpy-made inputs go through both packages: the fp8 helpers and
GEMM (kernels/fp8_matmul.py; JAX's Pallas kernel in interpret mode, as the
JAX package's own tests run it), the gate, the capacity dispatch, the YaRN
tables, and whole models built by the JAX package and converted with
utils/convert.py (`from_jax_ds_serving_params`, `from_jax_ds_fq`):
TINY_DEEPSEEK (sigmoid gate, groups, bias, q_lora) and `mini-deepseek`,
V2-Lite's routes at small widths: its wq, wo and experts are 128-aligned
and take the kernel route, while wkv_a (N = 192) and the dense FFN
(inter 320) are packed in 64-blocks and take fp8_matmul_ref, as
V2-Lite's wkv_a (576) and dense FFN (10944) do. On the CPU the port's
kernel wrapper runs its plain version; the route is counted.

Tolerances, and why:
  - fp8 codes, scales, expanded scales, gate indices and dispatch ranks:
    exact (the same integer or IEEE float32 operations);
  - the fp8 GEMM in float32: rtol/atol 1e-5, the JAX package's own bound
    for its kernel against its reference (the chunks' products sum in
    another order); the decode of all 254 non-NaN codes: exact;
  - gate weights: 1e-5 relative (XLA's and torch's float32 exp differ by
    ulps, and the softmax's sum and the renormalization carry them);
  - float32 models: layer by layer from JAX's inputs, and the logits,
    rows within 1e-4 but for rows a bf16 or W4A4 rounding tie moved
    (`_layers_teacher_forced`, `_close_up_to_ties`); generated and
    batched tokens equal (lm_head sharpened 6x against greedy ties, as
    tests/test_ds_batcher.py).
"""

import contextlib
import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flatquant_tpu.kernels import fp8_matmul as jf8
from flatquant_tpu.models import deepseek as jds
from flatquant_tpu.quantize.spec import W4A4 as J_W4A4
from flatquant_tpu.serving.batcher import ContinuousBatcher as JBatcher
from flatquant_torch.kernels import fp8_matmul as tf8
from flatquant_torch.models import deepseek as tds
from flatquant_torch.quantize.spec import W4A4
from flatquant_torch.serving.batcher import ContinuousBatcher
from flatquant_torch.utils.convert import (
    from_jax_ds_fq,
    from_jax_ds_serving_params,
)

torch.set_num_threads(2)

MINI_DS = dict(name="mini-deepseek", vocab_size=128, dim=256, inter_dim=320,
               moe_inter_dim=256, n_layers=2, n_dense_layers=1, n_heads=2,
               n_routed_experts=8, n_shared_experts=2, n_activated_experts=2,
               kv_lora_rank=128, qk_nope_head_dim=128, qk_rope_head_dim=64,
               v_head_dim=128, original_seq_len=64, max_seq_len=256,
               seqlen=64)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _u8(w8):
    if isinstance(w8, torch.Tensor):
        return w8.view(torch.uint8).numpy()
    return np.asarray(jax.lax.bitcast_convert_type(w8, jnp.uint8))


def _t8(codes):
    return torch.from_numpy(np.asarray(codes, np.uint8).copy()).view(
        torch.float8_e4m3fn)


# ---------------------------------------------------------------------------
# fp8 helpers and the GEMM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ftz", [True, False])
def test_block_quantize_byte_equal_to_jax(ftz):
    """Codes and scales of normal, subnormal-heavy and all-zero tiles, at
    blocks of 64 and 128, with the padding of a ragged shape."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(160, 200)).astype(np.float32) * 0.07
    w[:64, :64] = 0.0                 # a zero tile
    w[64:128] *= 1e-4                 # subnormal codes
    w[0, 100] = 3.0                   # one outlier tile
    for block in (64, 128):
        j8, js = jf8.fp8_block_quantize(jnp.asarray(w), block, ftz=ftz)
        t8, ts = tf8.fp8_block_quantize(_t(w), block, ftz=ftz)
        np.testing.assert_array_equal(_u8(t8), _u8(j8))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        em = _u8(t8) & 0x7F
        assert ((em > 0) & (em < 8)).any() != ftz
    big = np.array([[448.0, 449.0, 464.0, 464.5, 500.0, -470.0, 2.0 ** -10,
                     3 * 2.0 ** -10]], np.float32)
    np.testing.assert_array_equal(
        _u8(tf8._to_e4m3(_t(big))),
        np.asarray(jnp.asarray(big).astype(jnp.float8_e4m3fn).view(
            jnp.uint8)))


def test_expand_and_prep_equal_to_jax():
    rng = np.random.default_rng(1)
    for n, k in ((48, 64), (192, 256), (320, 256), (384, 256)):
        w = rng.normal(size=(n, k)).astype(np.float32)
        jl = jf8.prep_fp8_weight(jnp.asarray(w))
        tl = tf8.prep_fp8_weight(_t(w))
        np.testing.assert_array_equal(_u8(tl["w8"]), _u8(jl["w8"]))
        np.testing.assert_array_equal(tl["se"].numpy(), np.asarray(jl["se"]))
    s = rng.uniform(0.1, 1, (5, 56)).astype(np.float32)  # N=576, K=7168
    np.testing.assert_array_equal(
        tf8.expand_fp8_scales(_t(s), 576, 7168).numpy(),
        np.asarray(jf8.expand_fp8_scales(jnp.asarray(s), 576, 7168)))
    e = rng.normal(size=(3, 256, 128)).astype(np.float32)  # expert stack
    jl = jax.vmap(jf8.prep_fp8_weight)(jnp.asarray(e))
    tl = tf8.prep_fp8_weight(_t(e))
    np.testing.assert_array_equal(_u8(tl["w8"]), _u8(jl["w8"]))
    np.testing.assert_array_equal(tl["se"].numpy(), np.asarray(jl["se"]))


@pytest.mark.parametrize("exact", [True, False])
def test_all_codes_decode_like_jax(exact):
    """All 254 non-NaN codes through an identity x: the port (its plain
    version, the kernel's decode) equals JAX's kernel in interpret mode;
    the flush-to-zero decode zeroes exactly the subnormal codes."""
    codes = np.tile(np.arange(256, dtype=np.uint8), 64).reshape(128, 128)
    codes[(codes & 0x7F) == 0x7F] = 0
    x = np.eye(128, dtype=np.float32)
    want = np.asarray(jf8.fp8_matmul(
        jnp.asarray(x, jnp.bfloat16),
        jax.lax.bitcast_convert_type(jnp.asarray(codes), jnp.float8_e4m3fn),
        jnp.ones((1, 128), jnp.float32), out_dtype=jnp.float32, exact=exact,
        interpret=True))
    got = tf8.fp8_matmul(_t(x).to(torch.bfloat16), _t8(codes),
                         torch.ones(1, 128), torch.float32, exact).numpy()
    np.testing.assert_array_equal(got, want)
    sub = ((codes.T & 0x7F) > 0) & ((codes.T & 0x7F) < 8)
    assert (got[sub] == 0).all() != exact


@pytest.mark.parametrize("case", ["ftz pack", "subnormals", "experts"])
def test_fp8_matmul_matches_jax(case):
    """16 x 256 x 384 in float32 against JAX's kernel (interpret mode) and
    JAX's fp8_matmul_ref: ftz-packed weights (FTZ decode), subnormal codes
    (exact decode), and a stack of 3 experts in one call (JAX: vmap)."""
    rng = np.random.default_rng(2)
    M, K, N = 16, 256, 384
    x = jnp.asarray(rng.normal(size=(M, K)).astype(np.float32)).astype(
        jnp.bfloat16)
    w = rng.normal(size=(3 if case == "experts" else 1, N, K)) * 0.05
    if case == "subnormals":
        w[:, ::3] *= 1e-4
    exact = case != "ftz pack"
    w = jnp.asarray(w, jnp.float32)
    if case == "experts":
        lin = jax.vmap(jf8.prep_fp8_weight)(w)
    elif case == "subnormals":
        w8, s = jf8.fp8_block_quantize(w[0], ftz=False)
        lin = {"w8": w8, "se": jf8.expand_fp8_scales(s, N, K)}
    else:
        lin = jf8.prep_fp8_weight(w[0])
    tx = _t(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    tw8, tse = _t8(_u8(lin["w8"])), _t(lin["se"])
    if case == "experts":
        kern = jax.vmap(lambda a, b: jf8.fp8_matmul(
            x, a, b, out_dtype=jnp.float32, exact=True, interpret=True))(
            lin["w8"], lin["se"])
        ref = jax.vmap(lambda a, b: jf8.fp8_matmul_ref(
            x, a, b, out_dtype=jnp.float32))(lin["w8"], lin["se"])
        tx = tx[None].expand(3, M, K)
    else:
        kern = jf8.fp8_matmul(x, lin["w8"], lin["se"], out_dtype=jnp.float32,
                              exact=exact, interpret=True)
        ref = jf8.fp8_matmul_ref(x, lin["w8"], lin["se"],
                                 out_dtype=jnp.float32)
    got = tf8.fp8_matmul(tx, tw8, tse, torch.float32, exact).numpy()
    for want in (kern, ref):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def _count_routes(monkeypatch, module):
    """Count the calls fp8_linear makes of each route (not the port's
    wrapper calling its plain version on CPU tensors)."""
    n = {"fp8_matmul": 0, "fp8_matmul_ref": 0}
    depth = [0]
    for name in n:
        fn = getattr(module, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            n[_name] += depth[0] == 0
            depth[0] += 1
            try:
                return _fn(*a, **kw)
            finally:
                depth[0] -= 1

        monkeypatch.setattr(module, name, counted)
    return n


@pytest.mark.parametrize("case", ["aligned", "ragged N, 128-blocks",
                                  "64-blocks", "16-blocks"])
def test_fp8_linear_routes_like_jax(monkeypatch, case):
    """fp8_linear's dispatch with the kernel asked for: the kernel for a
    K packed in 128-blocks (a ragged N padded to 128: a crafted 128-block
    se at V3's wkv_a, N = 576, K = 7168), fp8_matmul_ref for 64- and
    16-blocks. Routes counted in both packages, outputs within 1e-5."""
    rng = np.random.default_rng(3)
    n, k = {"aligned": (384, 256), "ragged N, 128-blocks": (576, 7168),
            "64-blocks": (192, 256), "16-blocks": (48, 64)}[case]
    w = rng.normal(size=(n, k)).astype(np.float32) * 0.05
    if case == "ragged N, 128-blocks":
        w8, s = jf8.fp8_block_quantize(jnp.asarray(w), 128)
        jlin = {"w8": w8, "se": jf8.expand_fp8_scales(s, n, k)}
    else:
        jlin = jf8.prep_fp8_weight(jnp.asarray(w))
    x = rng.normal(size=(2, 3, k)).astype(np.float32)
    jn = _count_routes(monkeypatch, jf8)
    tn = _count_routes(monkeypatch, tf8)
    want = jf8.fp8_linear(jnp.asarray(x), jlin, out_dtype=jnp.float32,
                          use_kernel=True, exact=True)
    tlin = {"w8": _t8(_u8(jlin["w8"])),
            "se": _t(jlin["se"])}
    got = tf8.fp8_linear(_t(x), tlin, out_dtype=torch.float32,
                         use_kernel=True, exact=True)
    kernel = case in ("aligned", "ragged N, 128-blocks")
    assert jn == tn == {"fp8_matmul": int(kernel),
                        "fp8_matmul_ref": int(not kernel)}
    assert tuple(got.shape) == (2, 3, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# gate, dispatch, rope
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["tiny: sigmoid, groups, bias", "ties",
                                  "softmax, one group"])
def test_ds_gate_matches_jax(case):
    rng = np.random.default_rng(4)
    jcfg, tcfg = jds.TINY_DEEPSEEK, tds.TINY_DEEPSEEK
    if case == "softmax, one group":
        kw = dict(score_func="softmax", n_expert_groups=1,
                  n_limited_groups=1, route_scale=1.0, gate_bias=False)
        jcfg, tcfg = (dataclasses.replace(jcfg, **kw),
                      dataclasses.replace(tcfg, **kw))
    gw = rng.normal(size=(8, 64)).astype(np.float32)
    gb = rng.normal(size=8).astype(np.float32) * 0.1
    x = rng.normal(size=(9, 64)).astype(np.float32)
    if case == "ties":
        # experts 1 and 6 (other groups), 2 and 3 (one group) score equal,
        # and so do groups 0 and 3: the lower index must come first
        gw[6], gw[3] = gw[1], gw[2]
        gb[:] = 0.0
        gb[6], gb[3] = gb[1], gb[2]
        gw[0], gw[7] = gw[1] * 0.5, gw[6] * 0.5
    lp = {"gate_w": gw}
    if jcfg.gate_bias:
        lp["gate_b"] = gb
    jw, ji = jds.ds_gate(jcfg, {k: jnp.asarray(v) for k, v in lp.items()},
                         jnp.asarray(x))
    tw, ti = tds.ds_gate(tcfg, {k: _t(v) for k, v in lp.items()}, _t(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-7)


def test_moe_dispatch_matches_jax():
    fe = np.array([2, 2, 1, 2, 0, 1], np.int32)
    rank, keep = tds.moe_dispatch(torch.from_numpy(fe).long(), 2, 4)
    assert rank.tolist() == [0, 1, 0, 2, 0, 1]
    assert keep.tolist() == [True, True, True, False, True, True]
    fe = np.random.default_rng(5).integers(0, 8, 300).astype(np.int32)
    for cap in (1, 20, 40):
        jr, jk = jds.moe_dispatch(jnp.asarray(fe), cap, 8)
        tr, tk = tds.moe_dispatch(torch.from_numpy(fe).long(), cap, 8)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        assert 0 < tk.sum() <= 8 * cap


def test_yarn_tables_and_rope_match_jax():
    cfg = jds.DeepSeekConfig()  # V2-Lite: YaRN past 4096 positions
    rng = np.random.default_rng(6)
    for length in (2304, 5000):
        jc, js = jds.ds_rope_tables(cfg, length)
        tc, ts = tds.ds_rope_tables(tds.DeepSeekConfig(), length, "cpu")
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    x = rng.normal(size=(2, 7, 3, 64)).astype(np.float32)
    want = jds.apply_ds_rope(jnp.asarray(x), jc[100:107], js[100:107])
    got = tds.apply_ds_rope(_t(x), tc[100:107], ts[100:107])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    pos = np.array([3, 4097])
    want = jds._apply_ds_rope_per_slot(jnp.asarray(x[:, :1]), jc[pos],
                                       js[pos])
    got = tds._apply_ds_rope_per_slot(_t(x[:, :1]), tc[pos], ts[pos])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


def _jcfg(name):
    return jds.TINY_DEEPSEEK if name == "tiny" else jds.DeepSeekConfig(
        **MINI_DS)


def _tcfg(name):
    return tds.TINY_DEEPSEEK if name == "tiny" else tds.DeepSeekConfig(
        **MINI_DS)


@pytest.fixture(scope="module")
def models():
    """Per config: JAX's raw params (head sharpened 6x), its fp8 serving
    params and its packed W4A4 serving params with the baked state, each
    converted for the port."""
    out = {}
    for name in ("tiny", "mini"):
        jcfg = _jcfg(name)
        params = dict(jds.init_ds_params(jcfg, seed=0))
        params["head"] = params["head"] * 6.0
        # jitted: op by op, JAX's builders take ~30 s per model here
        fp8 = jax.jit(functools.partial(
            jds.build_ds_fp8_serving_params, jcfg, dtype=jnp.float32))(params)
        dfq, mfq = jds.init_ds_fq(jcfg, J_W4A4, seed=0)
        sp, baked = jax.jit(functools.partial(
            jds.build_ds_serving_params, jcfg, J_W4A4, dtype=jnp.float32))(
            params, dfq, mfq)
        out[name] = dict(
            raw=(params, None, from_jax_ds_serving_params(_np(params), "cpu"),
                 None),
            fp8=(fp8, None, from_jax_ds_serving_params(_np(fp8), "cpu"),
                 None),
            w4a4=(sp, baked, from_jax_ds_serving_params(_np(sp), "cpu"),
                  from_jax_ds_fq(_np(baked), "cpu")))
    return out


def test_fp8_serving_params_match_jax(models):
    """The port's build_ds_fp8_serving_params on the converted raw params
    packs the keys JAX's builder packs, each with the port's
    prep_fp8_weight (held byte for byte to JAX's op by op in
    test_expand_and_prep_equal_to_jax; the fixture's builder is jitted,
    and XLA divides by the constant 448 as a multiplication by its
    reciprocal, so its scales sit within one float32 ulp), and leaves
    every other leaf as JAX's builder does."""
    traw, jsp = models["mini"]["raw"][2], models["mini"]["fp8"][2]
    tsp = tds.build_ds_fp8_serving_params(_tcfg("mini"), traw,
                                          dtype=torch.float32)
    for group in ("dense_layers", "moe_layers"):
        for jl, tl, raw in zip(jsp[group], tsp[group], traw[group]):
            assert set(jl) == set(tl)
            for key, v in jl.items():
                if not isinstance(v, dict):
                    assert tl[key].dtype == v.dtype
                    assert torch.equal(tl[key], v), key
                    continue
                want = tf8.prep_fp8_weight(raw[key])
                assert torch.equal(tl[key]["w8"].view(torch.uint8),
                                   want["w8"].view(torch.uint8)), key
                assert torch.equal(tl[key]["se"], want["se"]), key
                assert tl[key]["w8"].shape == v["w8"].shape
                torch.testing.assert_close(tl[key]["se"], v["se"],
                                           rtol=2.0 ** -23, atol=0)


class _JaxKernelRoute:
    """Run JAX's DeepSeek path with its TPU routes on the CPU: fp8_linear
    with use_kernel=True (its Pallas kernel in interpret mode), counting
    fp8_matmul (per traced layer body) and fp8_matmul_ref calls."""

    def __init__(self, monkeypatch):
        self.n = _count_routes(monkeypatch, jf8)
        lin = jf8.fp8_linear
        monkeypatch.setattr(jf8, "fp8_linear", lambda *a, **kw: lin(
            *a, **dict(kw, use_kernel=True)))


@contextlib.contextmanager
def _layers_teacher_forced():
    """Record every call of JAX's ds_layer (input and output x) and run the
    port's ds_layer on JAX's input of the same call, recording its output:
    each layer is compared from the same input. (Both packages round
    activations to bf16 before every fp8 GEMM and to W4A4 codes before
    every int4 GEMM; a float32 sum taken in another order moves a value
    across such a rounding tie now and then, measured: 2 of the 6144 bf16
    inputs of mini's first wo, moving its output by 1.2e-4, and attention
    spreads that to every later position of the next layer.)"""
    rec = {"jax": [], "port": []}
    j_layer, t_layer = jds.ds_layer, tds.ds_layer

    def j_wrapped(cfg, fq_cfg, mode, lp, lfq, x, *a, **kw):
        out = j_layer(cfg, fq_cfg, mode, lp, lfq, x, *a, **kw)
        # inside lax.scan: the values arrive through a host callback
        jax.debug.callback(lambda xi, xo: rec["jax"].append(
            (np.asarray(xi), np.asarray(xo))), x, out, ordered=True)
        return out

    def t_wrapped(cfg, fq_cfg, mode, lp, lfq, x, *a, **kw):
        x_in = torch.from_numpy(rec["jax"][len(rec["port"])][0].copy())
        out = t_layer(cfg, fq_cfg, mode, lp, lfq, x_in, *a, **kw)
        rec["port"].append(out.numpy())
        return out

    jds.ds_layer, tds.ds_layer = j_wrapped, t_wrapped
    try:
        yield rec
    finally:
        jds.ds_layer, tds.ds_layer = j_layer, t_layer


def _close_up_to_ties(got, want, what):
    """float32 rows (last axis) within 1e-4, but for rows that a rounding
    tie moved (see _layers_teacher_forced): at most 10% of the rows beyond
    1e-4, every row within 1% of its norm (a W4A4 code step moves a row by
    ~2% of one channel; a wrong mask, scale, route or layout moves every
    row by far more)."""
    got, want = np.asarray(got), np.asarray(want)
    d = np.abs(got - want).max(axis=-1)
    rel = (d / np.maximum(np.linalg.norm(want, axis=-1), 1e-30)).max()
    frac = (d > 1e-4).mean()
    assert frac <= 0.1 and rel <= 0.01, (what, frac, rel)


FORWARDS = [("tiny", "raw", "dense"), ("tiny", "fp8", "gather"),
            ("tiny", "w4a4", "dense"), ("tiny", "w4a4", "gather"),
            ("mini", "fp8", "dense"), ("mini", "fp8", "auto"),
            ("mini", "w4a4", "auto")]


@pytest.mark.parametrize("name,form,moe", FORWARDS)
def test_deepseek_forward_matches_jax(models, monkeypatch, name, form, moe):
    """Float32 deepseek_forward in mode "fp" (raw) or "serve" (fp8: fq
    None; W4A4: the baked state), layer by layer from JAX's inputs, and
    the logits. moe "auto" at 256 tokens takes the gather MoE in serve
    mode; "dense"/"gather" force it. mini's fp8 routes are counted: per
    layer type, wq, wo and (MoE) the shared and the batched routed
    experts on the kernel route, wkv_a and the dense FFN on
    fp8_matmul_ref, in both packages."""
    jp, jfq, tp, tfq = models[name][form]
    jcfg, tcfg = _jcfg(name), _tcfg(name)
    if moe != "auto":
        jcfg = dataclasses.replace(jcfg, moe_impl=moe)
        tcfg = dataclasses.replace(tcfg, moe_impl=moe)
    B, S = (1, 256) if moe == "auto" else (2, 12)
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    mode = "fp" if form == "raw" else "serve"
    routes = _JaxKernelRoute(monkeypatch) if name == "mini" else None
    tn = _count_routes(monkeypatch, tf8)
    with _layers_teacher_forced() as rec:
        want = jds.deepseek_forward(jcfg, jp, jnp.asarray(toks), fq=jfq,
                                    fq_cfg=J_W4A4, mode=mode,
                                    compute_dtype=jnp.float32)
        jax.effects_barrier()
        got = tds.deepseek_forward(tcfg, tp, toks, fq=tfq, fq_cfg=W4A4,
                                   mode=mode, compute_dtype=torch.float32,
                                   device="cpu")
    assert len(rec["port"]) == len(rec["jax"]) == jcfg.n_layers
    for i, ((_, j_out), t_out) in enumerate(zip(rec["jax"], rec["port"])):
        _close_up_to_ties(t_out, j_out, f"layer {i}")
    _close_up_to_ties(got.numpy(), want, "logits")
    if routes is not None and form == "fp8":
        # the dense layer: wq, wo on the kernel, wkv_a, w1, w3, w2 on the
        # ref; the MoE layer: wq, wo, s_w1, s_w3, s_w2 and the batched
        # e_w1, e_w3, e_w2 on the kernel, wkv_a on the ref
        assert routes.n == tn == {"fp8_matmul": 10, "fp8_matmul_ref": 5}


@pytest.mark.parametrize("name,form", [("tiny", "w4a4"), ("mini", "fp8")])
def test_deepseek_generate_matches_jax(models, monkeypatch, name, form):
    jp, jfq, tp, tfq = models[name][form]
    prompt = np.random.default_rng(8).integers(
        0, 128, (2, 6)).astype(np.int32)
    if name == "mini":
        _JaxKernelRoute(monkeypatch)
    want = jds.deepseek_generate(_jcfg(name), jp, jfq, J_W4A4, prompt,
                                 max_new_tokens=4, max_len=32, mode="serve",
                                 compute_dtype=jnp.float32)
    got = tds.deepseek_generate(_tcfg(name), tp, tfq, W4A4, prompt,
                                max_new_tokens=4, max_len=32, mode="serve",
                                compute_dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(got, want)


PREFILL = {"whole": {}, "bucket": dict(prefill_bucket=8),
           "chunk": dict(prefill_chunk=8)}


@pytest.mark.parametrize("prefill", list(PREFILL))
def test_ds_batcher_matches_jax(models, prefill):
    """Packed W4A4 TINY_DEEPSEEK under both batchers with the DeepSeek
    hooks: mixed lengths through 2 slots (per-slot rope and masked latent
    writes in decode), token for token, and the final latent caches."""
    jp, jfq, tp, tfq = models["tiny"]["w4a4"]
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32)
               for n in (5, 11, 4)]
    kw = dict(batch_slots=2, max_len=32, **PREFILL[prefill])
    jb = JBatcher(jds.TINY_DEEPSEEK, J_W4A4, {"params": jp, "fq": jfq},
                  forward_fn=jds.ds_batch_forward,
                  init_cache_fn=jds.ds_init_batch_cache, **kw)
    tb = ContinuousBatcher(tds.TINY_DEEPSEEK, W4A4,
                           {"params": tp, "fq": tfq},
                           forward_fn=tds.ds_batch_forward,
                           init_cache_fn=tds.ds_init_batch_cache,
                           compute_dtype=torch.float32, device="cpu", **kw)
    for p, n in zip(prompts, (5, 3, 4)):
        assert jb.submit(p, n) == tb.submit(p, n)
    want = jb.run(max_steps=200)
    assert tb.run(max_steps=200) == want and len(want) == 3
    for key, layers in tb.cache.items():
        np.testing.assert_allclose(
            np.stack([c.numpy() for c in layers]), np.asarray(jb.cache[key]),
            rtol=1e-4, atol=1e-4, err_msg=key)


def test_ds_unported_parts_raise(models):
    """Calib mode on raw weights and build_ds_serving_params raised here
    until the calibrate -> eval slice ported them; they now match JAX:
    deepseek_forward in "calib" mode with the baked state (DeepSeek's
    eval) from JAX's converted state, float32 logits within 1e-4 up to
    rounding ties; the packed params from JAX's frozen state, codes equal
    but at ties (share at most 1e-3, one code) and scales within 1e-6
    relative (tests/test_torch_ds_calib.py has the reasons). What still
    raises: the int4 latent cache, and a CUDA device on a host without
    one."""
    from flatquant_torch.kernels.int4_matmul import unpack_weight_planar

    jp, tp = models["tiny"]["raw"][0], models["tiny"]["raw"][2]
    jsp, jbaked, tsp_want, tbaked = models["tiny"]["w4a4"]
    toks = np.random.default_rng(3).integers(0, 256, (2, 12))
    jl = jax.jit(lambda p, f, t: jds.deepseek_forward(
        jds.TINY_DEEPSEEK, p, t, fq=f, fq_cfg=J_W4A4, mode="calib",
        compute_dtype=jnp.float32))(jp, jbaked, jnp.asarray(toks))
    tl = tds.deepseek_forward(tds.TINY_DEEPSEEK, tp, toks, fq=tbaked,
                              fq_cfg=W4A4, mode="calib",
                              compute_dtype=torch.float32, device="cpu")
    _close_up_to_ties(tl.numpy(), jl, "calib-mode logits")
    tsp, _ = tds.build_ds_serving_params(tds.TINY_DEEPSEEK, W4A4, tp,
                                         *tbaked, dtype=torch.float32)
    flips = total = 0
    for group in ("dense_layers", "moe_layers"):
        for g, w in zip(tsp[group], tsp_want[group]):
            assert set(g) == set(w)
            for key, v in w.items():
                if not isinstance(v, dict):
                    assert torch.equal(g[key], v), key
                    continue
                d = (unpack_weight_planar(g[key]["wp"].flatten(0, -2)).int()
                     - unpack_weight_planar(v["wp"].flatten(0, -2)).int())
                assert d.abs().max() <= 1, key
                flips += int((d != 0).sum())
                total += d.numel()
                np.testing.assert_allclose(g[key]["scale"].numpy(),
                                           v["scale"].numpy(), rtol=1e-6)
                for a, b in zip(g[key].get("a_clip", ()),
                                v.get("a_clip", ())):
                    assert torch.equal(a, b), key
    assert flips <= 1e-3 * total, f"{flips} of {total} codes differ"
    with pytest.raises(ValueError, match="bf16"):
        tds.ds_init_batch_cache(tds.TINY_DEEPSEEK, 1, 8, mode="int4",
                                device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tds.deepseek_forward(tds.TINY_DEEPSEEK, tp, np.zeros((1, 4), int))
