"""The grouped-layout pipeline (rows 22-27 of PERF.md's kernel table)
against the JAX package, on the CPU.

Kernels: inputs made with numpy from a seed go through JAX's Pallas kernel
(kernels/grouped_mlp.py) in interpret mode, as tests/test_grouped_mlp.py
runs it, and through the port's wrapper, which on CPU tensors runs its
plain version. Slice: a 2-layer `mini-128` model (hidden 256 -> G = 2,
intermediate 512 -> G = 4, head_dim 128) built in JAX with W4A4KV4 +
tpu_decompose and converted with utils/convert.py.

Tolerances, and why (JAX's own bounds, tests/test_grouped_mlp.py):
  - row 25 (w4a4_matmul_i8_grouped): bit for bit, f32 and bf16 outputs:
    exact integer sums, the same epilogue order;
  - row 27 (w4a4_swiglu_grouped_gx): bit for bit against the port's row 22
    on group_layout(x); against JAX's kernel row 22's bound;
  - rows 22 and 26: rtol/atol 2e-2 and at least 95% of the bf16 outputs
    bit-equal: the 128-deep right products sum in another order in XLA's
    dot than in torch's matmul, so a bf16 output may round one ulp apart;
  - rows 23 and 24: scales to rtol 2e-7 and codes apart on under 3e-3 of
    them: JAX's interpret mode divides by q_max as a multiplication by the
    reciprocal (one float32 ulp), which moves a code at a rounding tie.
Each grouped wrapper equals its flat twin's through the layout glue bit
for bit, and the port's prefill through the grouped routes gives the flat
routes' logits bit for bit. The CUDA kernels are held to these plain
versions and to their twins on the card by tests/test_torch_gpu.py and
chip_smoke.py (phases 3j and 12).
"""

import contextlib
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flatquant_tpu.core.orth import random_orthogonal
from flatquant_tpu.kernels import grouped_mlp as jgm
from flatquant_tpu.kernels.int4_matmul import pack_weight_planar
from flatquant_tpu.kernels.int4_matmul import w4a8_matmul_ref as j_w4a8_ref
from flatquant_tpu.models.config import LlamaConfig as JLlamaConfig
from flatquant_tpu.models.llama import init_params as j_init_params
from flatquant_tpu.quantize.bake import bake_model
from flatquant_tpu.quantize.spec import W4A4KV4 as J_W4A4KV4
from flatquant_tpu.quantize.state import init_model_fq
from flatquant_tpu.serving.quantized import (
    build_serving_params as j_build_serving_params,
)
from flatquant_tpu.serving.quantized import kron_transform as j_kron
from flatquant_torch.kernels import common
from flatquant_torch.kernels import flat_pipeline as tfp
from flatquant_torch.kernels import grouped_mlp as tgm
from flatquant_torch.kernels import int4_matmul as tmm
from flatquant_torch.models.config import LlamaConfig
from flatquant_torch.quantize.spec import W4A4KV4
from flatquant_torch.serving import engine as te
from flatquant_torch.serving import quantized as tq
from flatquant_torch.utils.convert import from_jax_serving_params

torch.set_num_threads(2)

MINI = dict(name="mini-128", vocab_size=128, hidden_size=256,
            intermediate_size=512, num_layers=2, num_heads=2,
            num_kv_heads=2, head_dim=128, seqlen=256)


def _t(a):
    """numpy/JAX array -> torch CPU tensor (bf16 widened exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _close_bf16(got, want, what):
    """Rows 22 and 26 (and 27 against JAX): JAX's bounds."""
    g, w = _f32(got), _f32(want)
    np.testing.assert_allclose(g, w, rtol=2e-2, atol=2e-2, err_msg=what)
    eq = np.mean(g == w)
    assert eq > 0.95, (what, eq)


def _close_quant(got, want, what):
    """Rows 23 and 24: (codes, scales) against JAX's."""
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=2e-7, err_msg=what)
    mism = np.mean(got[0].numpy() != np.asarray(want[0]))
    assert mism < 3e-3, (what, mism)


def _clips(use_clip):
    if not use_clip:
        return None, None
    pair = (np.float32(0.9), np.float32(0.8))
    return (tuple(jnp.asarray(c) for c in pair),
            tuple(torch.tensor(c) for c in pair))


def _gemm_inputs(rng, m, k, n):
    w = rng.integers(-8, 8, (n, k)).astype(np.int8)
    wp = np.asarray(pack_weight_planar(jnp.asarray(w)))
    sw = rng.uniform(0.01, 0.05, (n,)).astype(np.float32)
    xq = rng.integers(-8, 8, (m, k)).astype(np.int8)
    xs = rng.uniform(0.1, 1.0, (m, 1)).astype(np.float32)
    return xq, xs, wp, sw


# ---------------------------------------------------------------------------
# the six functions against JAX's interpret kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_w4a4_matmul_i8_grouped_bit_exact_vs_jax(rng, out):
    G, m, n = 6, 64, 384
    xq, xs, wp, sw = _gemm_inputs(rng, m, G * 128, n)
    xg = np.asarray(jgm.group_layout(jnp.asarray(xq), G))
    want = jgm.w4a4_matmul_i8_grouped(
        jnp.asarray(xg), jnp.asarray(xs), jnp.asarray(wp), jnp.asarray(sw),
        jnp.dtype(out), block_m=32, block_n=128, interpret=True)
    before = common.LAUNCHES["w4a4_matmul_i8_grouped"]
    got = tgm.w4a4_matmul_i8_grouped(_t(xg), _t(xs), _t(wp), _t(sw),
                                     getattr(torch, out))
    assert common.LAUNCHES["w4a4_matmul_i8_grouped"] == before  # plain route
    assert got.dtype == getattr(torch, out) and got.shape == (m, n)
    np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("G", [4, 5])
def test_w4a4_swiglu_grouped_matches_jax(rng, G):
    m, k = 256, 256
    nh = G * 128
    xq, xs, wp, sw = _gemm_inputs(rng, m, k, 2 * nh)
    right = (rng.standard_normal((128, 128)) * 0.2).astype(np.float32)
    want = jgm.w4a4_swiglu_grouped(jnp.asarray(xq), jnp.asarray(xs),
                                   jnp.asarray(wp), jnp.asarray(sw),
                                   jnp.asarray(right), interpret=True)
    got = tgm.w4a4_swiglu_grouped(_t(xq), _t(xs), _t(wp), _t(sw), _t(right))
    assert got.shape == (G, m, 128) and got.dtype == torch.bfloat16
    _close_bf16(got, want, "w4a4_swiglu_grouped")


@pytest.mark.parametrize("block_n", [512, 128])
def test_w4a4_swiglu_grouped_gx_matches_row_22_and_jax(rng, block_n):
    """Bit for bit against the port's row 22 on the same codes, and JAX's
    grouped-x kernel (block_n=128: four N blocks over its hoisted scratch)
    within row 22's bound."""
    m, gin, G = 128, 2, 4
    xq, xs, wp, sw = _gemm_inputs(rng, m, gin * 128, 2 * G * 128)
    right = np.asarray(random_orthogonal(128, rng), np.float32)
    xg = np.asarray(jgm.group_layout(jnp.asarray(xq), gin))
    got = tgm.w4a4_swiglu_grouped_gx(_t(xg), _t(xs), _t(wp), _t(sw),
                                     _t(right))
    row22 = tgm.w4a4_swiglu_grouped(_t(xq), _t(xs), _t(wp), _t(sw),
                                    _t(right))
    assert torch.equal(got, row22)
    want = jgm.w4a4_swiglu_grouped_gx(
        jnp.asarray(xg), jnp.asarray(xs), jnp.asarray(wp), jnp.asarray(sw),
        jnp.asarray(right, jnp.bfloat16), block_n=block_n, interpret=True)
    _close_bf16(got, want, "w4a4_swiglu_grouped_gx")


@pytest.mark.parametrize("G", [4, 5])
def test_rmsnorm_right_grouped_matches_jax(rng, G):
    t, h = 96, G * 128
    x = jnp.asarray(rng.standard_normal((t, h)) * 2.0, jnp.bfloat16)
    w = rng.uniform(0.5, 1.5, (h,)).astype(np.float32)
    right = jnp.asarray(random_orthogonal(128, rng), jnp.bfloat16)
    want = jgm.rmsnorm_right_grouped(x, jnp.asarray(w), right, 1e-5,
                                     interpret=True)
    got = tgm.rmsnorm_right_grouped(_t(x), _t(w), _t(right), 1e-5)
    assert got.shape == (G, t, 128) and got.dtype == torch.bfloat16
    _close_bf16(got, want, "rmsnorm_right_grouped")


@pytest.mark.parametrize("use_clip", [False, True])
def test_left_quant_i8_grouped_matches_jax(rng, use_clip):
    G, t = 6, 96
    x = (rng.standard_normal((G, t, 128)) * 1.5).astype(np.float32)
    x[:, 3] = 0.0  # a zero token row: scale 1, codes 0
    x = jnp.asarray(x, jnp.bfloat16)
    left = jnp.asarray(random_orthogonal(G, rng), jnp.bfloat16)
    jclip, tclip = _clips(use_clip)
    want = jgm.left_quant_i8_grouped(left.T, x, clip=jclip, q_max=7,
                                     interpret=True)
    got = tgm.left_quant_i8_grouped(_t(left).T, _t(x), tclip, 7)
    assert got[0].shape == (G, t, 128) and got[1].shape == (t, 1)
    _close_quant(got, want, "left_quant_i8_grouped")
    assert got[1][3].item() == 1.0 and not got[0][:, 3].any()


@pytest.mark.parametrize("use_clip", [False, True])
def test_quant_acts_i8_grouped_matches_jax(rng, use_clip):
    G, t = 6, 96
    x = rng.standard_normal((t, G * 128)).astype(np.float32) * 2.0
    x[3] = 0.0
    xg = jgm.group_layout(jnp.asarray(x, jnp.bfloat16), G)
    jclip, tclip = _clips(use_clip)
    want = jgm.quant_acts_i8_grouped(xg, clip=jclip, q_max=7, interpret=True)
    got = tgm.quant_acts_i8_grouped(_t(xg), tclip, 7)
    assert got[0].shape == (G, t, 128) and got[1].shape == (t, 1)
    _close_quant(got, want, "quant_acts_i8_grouped")
    assert got[1][3].item() == 1.0 and not got[0][:, 3].any()


# ---------------------------------------------------------------------------
# each grouped wrapper against its flat twin through the layout glue
# ---------------------------------------------------------------------------


def _twins(rng):
    """{row: (grouped result, flat twin's result through the glue)} on one
    set of seeded inputs: T = 96 rows, G = 6 input groups, 4 output
    groups."""
    T, G, NH = 96, 6, 512
    g = torch.Generator().manual_seed(0)
    x = (torch.randn((T, G * 128), generator=g) * 2).to(torch.bfloat16)
    xg = tgm.group_layout(x, G)
    w = torch.rand((G * 128,), generator=g) + 0.5
    right = torch.randn((128, 128), generator=g) * 0.1
    left_t = torch.randn((G, G), generator=g) * 0.4
    clip = (torch.tensor(0.9), torch.tensor(0.85))
    xq, xs, wp, sw = (_t(a) for a in _gemm_inputs(rng, T, G * 128, 2 * NH))
    xqg = tgm.group_layout(xq, G)
    ungroup_q = lambda r: (tgm.ungroup_layout(r[0]), r[1])
    return {
        22: (tgm.ungroup_layout(tgm.w4a4_swiglu_grouped(xq, xs, wp, sw,
                                                        right)),
             tfp.w4a4_matmul_i8_swiglu_right(xq, xs, wp, sw, right)),
        23: (ungroup_q(tgm.left_quant_i8_grouped(left_t, xg, clip)),
             tfp.left_quant_i8_flat(left_t, x, clip)),
        24: (ungroup_q(tgm.quant_acts_i8_grouped(xg, clip)),
             tmm.quant_acts_i8(x, clip)),
        25: (tgm.w4a4_matmul_i8_grouped(xqg, xs, wp[:384], sw[:384],
                                        torch.float32),
             tmm.w4a4_matmul_i8(xq, xs, wp[:384], sw[:384], torch.float32)),
        26: (tgm.ungroup_layout(tgm.rmsnorm_right_grouped(x, w, right,
                                                          1e-5)),
             tfp.rmsnorm_right_flat(x, w, right, 1e-5)),
        27: (tgm.ungroup_layout(tgm.w4a4_swiglu_grouped_gx(xqg, xs, wp, sw,
                                                           right)),
             tfp.w4a4_matmul_i8_swiglu_right(xq, xs, wp, sw, right)),
    }


@pytest.mark.parametrize("row", [22, 23, 24, 25, 26, 27])
def test_grouped_equals_flat_twin(rng, row):
    got, want = _twins(rng)[row]
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), row


def test_layout_glue_round_trips():
    x = torch.arange(5 * 3 * 128).reshape(5, 3 * 128)
    xg = tgm.group_layout(x, 3)
    assert xg.shape == (3, 5, 128) and xg.is_contiguous()
    assert torch.equal(xg[1, 2], x[2, 128:256])
    assert torch.equal(tgm.ungroup_layout(xg), x)
    np.testing.assert_array_equal(
        xg.numpy(), np.asarray(jgm.group_layout(jnp.asarray(x.numpy()), 3)))


# ---------------------------------------------------------------------------
# the slice: mini-128's serving layers through the grouped routes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    jcfg = JLlamaConfig(**MINI)
    jfq = dataclasses.replace(J_W4A4KV4, tpu_decompose=True)
    params = j_init_params(jcfg, seed=0)
    params["lm_head"] = params["lm_head"] * 6.0  # sharpen: no greedy ties
    bp, bfq = bake_model(jcfg, jfq, params, init_model_fq(jcfg, jfq, seed=0))
    sp = j_build_serving_params(jcfg, jfq, bp, bfq, dtype=jnp.bfloat16,
                                merge_projections=True)
    sp = jax.tree.map(np.asarray, sp)
    jsl = jax.tree.map(lambda a: a[0], sp["layers"])  # layer 0
    return dict(jcfg=jcfg, jsl=jsl, cfg=LlamaConfig(**MINI),
                fq=dataclasses.replace(W4A4KV4, tpu_decompose=True),
                tsp=from_jax_serving_params(sp, device="cpu"))


def _layer_input(rng, T=256, H=256):
    return jnp.asarray(rng.standard_normal((T, H)) * 1.5, jnp.bfloat16)


def _jclip(lin):
    c = lin.get("a_clip")
    return None if c is None else tuple(jnp.asarray(v) for v in c)


def test_grouped_attention_input_matches_jax(model, rng):
    """Rows 26 -> 23 -> 25 on layer 0 of mini-128: each stage of the port
    from JAX's input to that stage, within the row's bound; the port's
    route equals its stages composed."""
    jsl, tsl = model["jsl"], model["tsp"]["layers"][0]
    eps = model["cfg"].rms_eps
    x = _layer_input(rng)
    left, right = (jnp.asarray(a) for a in jsl["ln_t"])
    hg = jgm.rmsnorm_right_grouped(x, jnp.asarray(jsl["ln1_w"]), right, eps,
                                   interpret=True)
    q = jgm.left_quant_i8_grouped(left.T, hg, clip=_jclip(jsl["qkv"]),
                                  q_max=7, interpret=True)
    y = jgm.w4a4_matmul_i8_grouped(q[0], q[1], jnp.asarray(jsl["qkv"]["wp"]),
                                   jnp.asarray(jsl["qkv"]["scale"]),
                                   jnp.bfloat16, interpret=True)
    tl, tr = tsl["ln_t"]
    _close_bf16(tgm.rmsnorm_right_grouped(_t(x), tsl["ln1_w"], tr, eps), hg,
                "attention input: row 26")
    _close_quant(tgm.left_quant_i8_grouped(
        tl.T, _t(hg), tsl["qkv"].get("a_clip"), 7), q,
        "attention input: row 23")
    got = tgm.w4a4_matmul_i8_grouped(_t(q[0]), _t(q[1]), tsl["qkv"]["wp"],
                                     tsl["qkv"]["scale"], torch.bfloat16)
    np.testing.assert_array_equal(_f32(got), _f32(y))

    route = tq._grouped_layout_attn_in(_t(x), tsl, eps, torch.bfloat16, 7)
    hg_t = tgm.rmsnorm_right_grouped(_t(x), tsl["ln1_w"], tr, eps)
    q_t = tgm.left_quant_i8_grouped(tl.T, hg_t, tsl["qkv"].get("a_clip"), 7)
    assert torch.equal(route, tgm.w4a4_matmul_i8_grouped(
        *q_t, tsl["qkv"]["wp"], tsl["qkv"]["scale"], torch.bfloat16))


def test_fully_grouped_mlp_matches_jax(model, rng):
    """Rows 26 -> 23 -> 27 -> 23 -> 25 on layer 0's MLP, each stage from
    JAX's input to it, within the row's bound."""
    jsl, tsl = model["jsl"], model["tsp"]["layers"][0]
    eps = model["cfg"].rms_eps
    x = _layer_input(rng)
    ug, dn = jsl["upgate"], jsl["down"]
    ug_l, ug_r = (jnp.asarray(a) for a in jsl["ug_t"])
    dn_l, dn_r = (jnp.asarray(a) for a in jsl["down_t"])
    hg = jgm.rmsnorm_right_grouped(x, jnp.asarray(jsl["ln2_w"]), ug_r, eps,
                                   interpret=True)
    q1 = jgm.left_quant_i8_grouped(ug_l.T, hg, clip=_jclip(ug), q_max=7,
                                   interpret=True)
    yg = jgm.w4a4_swiglu_grouped_gx(q1[0], q1[1], jnp.asarray(ug["wp"]),
                                    jnp.asarray(ug["scale"]), dn_r,
                                    interpret=True)
    q2 = jgm.left_quant_i8_grouped(dn_l.T, yg, clip=_jclip(dn), q_max=7,
                                   interpret=True)
    out = jgm.w4a4_matmul_i8_grouped(q2[0], q2[1], jnp.asarray(dn["wp"]),
                                     jnp.asarray(dn["scale"]), jnp.bfloat16,
                                     interpret=True)
    tug, tdn = tsl["upgate"], tsl["down"]
    (tul, tur), (tdl, tdr) = tsl["ug_t"], tsl["down_t"]
    assert yg.shape == (4, 256, 128)
    _close_bf16(tgm.rmsnorm_right_grouped(_t(x), tsl["ln2_w"], tur, eps), hg,
                "MLP: row 26")
    _close_quant(tgm.left_quant_i8_grouped(tul.T, _t(hg), tug.get("a_clip"),
                                           7), q1, "MLP: row 23 (ug)")
    _close_bf16(tgm.w4a4_swiglu_grouped_gx(_t(q1[0]), _t(q1[1]), tug["wp"],
                                           tug["scale"], tdr), yg,
                "MLP: row 27")
    _close_quant(tgm.left_quant_i8_grouped(tdl.T, _t(yg), tdn.get("a_clip"),
                                           7), q2, "MLP: row 23 (down)")
    got = tgm.w4a4_matmul_i8_grouped(_t(q2[0]), _t(q2[1]), tdn["wp"],
                                     tdn["scale"], torch.bfloat16)
    np.testing.assert_array_equal(_f32(got), _f32(out))


@contextlib.contextmanager
def _grouped_routes(counts):
    """The engine's fused input and MLP routes sent through the grouped
    layout, counting the grouped wrappers' calls."""
    names = ["rmsnorm_right_grouped", "left_quant_i8_grouped",
             "w4a4_swiglu_grouped_gx", "w4a4_matmul_i8_grouped",
             "rmsnorm_right_flat", "left_quant_i8_flat",
             "w4a4_matmul_i8_swiglu_right"]
    saved = [(tq, n, getattr(tq, n)) for n in names]
    saved += [(m, n, getattr(m, n)) for m in (tq, te)
              for n in ("_grouped_attn_in", "_quant_mlp_grouped_full")]

    for n in names:
        setattr(tq, n, _counted(counts, n, getattr(tq, n)))
    for m in (tq, te):
        m._grouped_attn_in = tq._grouped_layout_attn_in
        m._quant_mlp_grouped_full = tq._grouped_layout_mlp_full
    try:
        yield counts
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def test_prefill_through_grouped_routes_equals_flat(model):
    """The port's serving_prefill (1 x 256, bf16, int4 cache) with the
    fused input and MLP routes on the grouped layout gives the flat
    routes' logits and cache bit for bit."""
    cfg, fq, tsp = model["cfg"], model["fq"], model["tsp"]
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 256)).astype(np.int32)

    def prefill():
        c = te.init_cache(cfg, 1, 384, mode="int4", device="cpu")
        return te.serving_prefill(cfg, fq, tsp, toks, c, max_len=384,
                                  compute_dtype=torch.bfloat16, device="cpu")

    flat_logits, flat_cache = prefill()
    with _grouped_routes({}) as n:
        logits, cache = prefill()
    L = cfg.num_layers
    assert n == {"rmsnorm_right_grouped": 2 * L,
                 "left_quant_i8_grouped": 3 * L,
                 "w4a4_swiglu_grouped_gx": L,
                 "w4a4_matmul_i8_grouped": 2 * L}, n
    assert torch.equal(logits, flat_logits)
    for key in ("kp", "kparam", "vp", "vparam"):
        for a, b in zip(cache[key], flat_cache[key]):
            assert torch.equal(a, b), key


def test_round2_tail_matches_jax_composed(rng):
    """JAX's test_grouped_pipeline_end_to_end on the port's round-2 tail
    (row 22 -> the bf16 left product -> row 24 -> row 25), within that
    test's tolerances of JAX's composed route."""
    m, k, G = 256, 256, 4
    nh = G * 128
    wug = jnp.asarray(rng.integers(-8, 8, (2 * nh, k)), jnp.int8)
    wug_p = pack_weight_planar(wug)
    s_ug = jnp.asarray(rng.uniform(0.01, 0.05, (2 * nh,)), jnp.float32)
    wd = jnp.asarray(rng.integers(-8, 8, (k, nh)), jnp.int8)
    wd_p = pack_weight_planar(wd)
    s_d = jnp.asarray(rng.uniform(0.005, 0.02, (k,)), jnp.float32)
    left = jnp.asarray(random_orthogonal(G, rng), jnp.bfloat16)
    right = jnp.asarray(random_orthogonal(128, rng), jnp.bfloat16)
    xq = jnp.asarray(rng.integers(-8, 8, (m, k)), jnp.int8)
    xs = jnp.asarray(rng.uniform(0.1, 0.5, (m, 1)), jnp.float32)

    # JAX's composed route (its test's reference)
    y = j_w4a8_ref(xq, xs, wug_p, s_ug, out_dtype=jnp.float32)
    up, gate = jnp.split(y, 2, axis=-1)
    act = (up * (gate * jax.nn.sigmoid(gate))).astype(jnp.bfloat16)
    zf = j_kron(act, (left, right)).astype(jnp.float32)
    am = jnp.max(jnp.abs(zf), axis=-1, keepdims=True)
    zs = jnp.where(am == 0, 1.0, am / 7)
    zq = jnp.clip(jnp.round(zf / zs), -8, 7).astype(jnp.int8)
    want = j_w4a8_ref(zq, zs, wd_p, s_d, jnp.float32)

    calls, scales = {}, []

    def down_gemm(zq, zs, *a):
        scales.append(zs)
        return tgm.w4a4_matmul_i8_grouped(zq, zs, *a)

    with contextlib.ExitStack() as stack:
        for name in ("w4a4_swiglu_grouped", "quant_acts_i8_grouped"):
            stack.enter_context(_patched(
                tq, name, _counted(calls, name, getattr(tq, name))))
        stack.enter_context(_patched(tq, "w4a4_matmul_i8_grouped", down_gemm))
        got = tq._round2_mlp_tail(
            _t(xq), _t(xs), {"wp": _t(wug_p), "scale": _t(s_ug)},
            {"wp": _t(wd_p), "scale": _t(s_d)}, (_t(left), _t(right)),
            torch.float32, 7)
    assert calls == {"w4a4_swiglu_grouped": 1,
                     "quant_acts_i8_grouped": 1} and len(scales) == 1, calls
    zs_got = scales[0]
    np.testing.assert_allclose(zs_got.numpy(), np.asarray(zs), rtol=3e-2)
    scale_bound = float(jnp.max(zs)) * float(jnp.max(jnp.abs(s_d))) * k
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-2,
                               atol=0.05 * scale_bound)


@contextlib.contextmanager
def _patched(module, name, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def _counted(n, name, fn):
    def wrapped(*a, **kw):
        n[name] = n.get(name, 0) + 1
        return fn(*a, **kw)
    return wrapped
