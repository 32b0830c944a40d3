"""The port's build chain (init_model_fq -> bake_model ->
build_serving_params), its layouts and the Llama forward modes against
the JAX package, on the CPU.

Models: `mini-128` (head_dim 128, W4A4KV4 + tpu_decompose: the rn128
split), `tiny-llama` and `mini-qwen` (the balanced split, qkv bias), with
weights and FQ state from the same seeds in both packages.

Tolerances, and why:
  - init_model_fq: bit for bit (both draw on the host in float64 numpy,
    in the same order, and round to float32 once).
  - the Cayley map and factor matrices: a float32 solve of (I - A/2) is
    exact to cond(I - A/2) x 2^-23 (backward stable), and JAX's LAPACK LU
    + XLA triangular solves and torch's solve round differently within
    that: each side within that bound of the float64 map, and of each
    other (random rotations make cond 20-5000; at cond < 84 the bound is
    under 1e-5). The Newton inverse of a well-conditioned matrix: 1e-5.
  - bake_model from JAX's frozen transforms: 1e-5 relative (measured: the
    weights equal but for wdown, one ulp on ~38% of it, where the float32
    Kronecker product over a left factor of 4 sums in another order).
    From the port's own FQ state the frozen transforms themselves differ
    at the Cayley bound, and the weights with them (within 5e-4
    relative; measured 9e-5).
  - build_serving_params on JAX's baked state: wp, scale and a_clip byte
    for byte, in every layout. From the port's own chain: the codes of
    the two chains' values differ only where those values straddle a
    rounding tie (each value within 2e-3 of the other's, in code units),
    by one code, on at most 0.1% of the nibbles (the counts are in the
    assertion messages).
  - serving (f32): logits within 1e-4 of JAX's engine with its Pallas
    kernels in interpret mode, greedy tokens equal, caches as
    tests/test_torch_serving.py holds them.
  - llama_forward: logits within 1e-4 (float32, summation order only).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flatquant_tpu.core import kron as jkron
from flatquant_tpu.core import orth as jorth
from flatquant_tpu.core import transforms as jtr
from flatquant_tpu.models import llama as jl
from flatquant_tpu.models.config import LlamaConfig as JLlamaConfig
from flatquant_tpu.models.config import get_config as j_get_config
from flatquant_tpu.quantize import bake as jbake
from flatquant_tpu.quantize.spec import W4A4KV4 as J_W4A4KV4
from flatquant_tpu.quantize.state import bake_layer_fq as j_bake_layer_fq
from flatquant_tpu.quantize.state import init_model_fq as j_init_model_fq
from flatquant_tpu.quantize.state import slice_layer
from flatquant_tpu.serving import engine as je
from flatquant_tpu.serving.quantized import (
    build_serving_params as j_build_serving_params,
)
from flatquant_torch.core import kron as tkron
from flatquant_torch.core import orth as torth
from flatquant_torch.core import transforms as ttr
from flatquant_torch.kernels.int4_matmul import unpack_weight_planar
from flatquant_torch.models import llama as tl
from flatquant_torch.models.config import LlamaConfig
from flatquant_torch.models.config import get_config
from flatquant_torch.quantize import bake as tbake
from flatquant_torch.quantize.spec import W4A4KV4
from flatquant_torch.quantize.state import LayerFQ, init_model_fq
from flatquant_torch.serving import engine as te
from flatquant_torch.serving.batcher import ContinuousBatcher
from flatquant_torch.serving.quantized import build_serving_params
from flatquant_torch.utils.convert import (
    from_jax_fq,
    from_jax_params,
    from_jax_serving_params,
)

torch.set_num_threads(2)

MINI = dict(name="mini-128", vocab_size=128, hidden_size=256,
            intermediate_size=512, num_layers=2, num_heads=2,
            num_kv_heads=2, head_dim=128, seqlen=256)
MINI_QWEN = dict(name="mini-qwen", vocab_size=128, hidden_size=896,
                 intermediate_size=8448, num_layers=2, num_heads=7,
                 num_kv_heads=1, head_dim=128, rope_theta=1e6, rms_eps=1e-6,
                 attn_bias=True, seqlen=256)
LAYOUTS = {"merged": dict(merge_projections=True),
           "unmerged": {},
           "perm": dict(merge_projections=True, perm_transforms=True),
           "perm-unmerged": dict(perm_transforms=True)}
EPS32 = 2.0 ** -23


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _same_tree(got, want, path="fq"):
    """A port FQ tree (dataclasses of tensors) against a converted one:
    the same classes and None entries, every tensor bit for bit."""
    assert type(got) is type(want), path
    if dataclasses.is_dataclass(got):
        for f in dataclasses.fields(got):
            _same_tree(getattr(got, f.name), getattr(want, f.name),
                       f"{path}.{f.name}")
    elif torch.is_tensor(got):
        assert got.dtype == want.dtype and torch.equal(got, want), path
    else:
        assert got == want, path


@pytest.fixture(scope="module")
def mini():
    jcfg, cfg = JLlamaConfig(**MINI), LlamaConfig(**MINI)
    jfq = dataclasses.replace(J_W4A4KV4, tpu_decompose=True)
    fq = dataclasses.replace(W4A4KV4, tpu_decompose=True)
    jp = jl.init_params(jcfg, seed=0)
    jp["lm_head"] = jp["lm_head"] * 6.0  # sharpen: no greedy ties
    js = j_init_model_fq(jcfg, jfq, seed=0)
    jbp, jbf = jbake.bake_model(jcfg, jfq, jp, js)
    return dict(jcfg=jcfg, cfg=cfg, jfq=jfq, fq=fq, jp=jp, js=js, jbp=jbp,
                jbf=jbf, tp=from_jax_params(_np(jp), "cpu"),
                tbp=from_jax_params(_np(jbp), "cpu"),
                tbf=from_jax_fq(_np(jbf), "cpu"))


# ---------------------------------------------------------------------------
# FQ state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("direct_inv", [False, True])
@pytest.mark.parametrize("add_diag", [False, True])
def test_init_model_fq_bit_equal_tiny(seed, direct_inv, add_diag):
    jcfg, cfg = j_get_config("tiny-llama"), get_config("tiny-llama")
    kw = dict(direct_inv=direct_inv, add_diag=add_diag)
    want = from_jax_fq(_np(j_init_model_fq(
        jcfg, dataclasses.replace(J_W4A4KV4, **kw), seed=seed)), "cpu")
    got = init_model_fq(cfg, dataclasses.replace(W4A4KV4, **kw), seed=seed,
                        device="cpu")
    assert len(got) == cfg.num_layers and isinstance(got[0], LayerFQ)
    for i, (g, w) in enumerate(zip(got, want)):
        _same_tree(g, w, f"layer {i}")


@pytest.mark.parametrize("shape", ["mini-128", "mini-qwen"])
def test_init_model_fq_bit_equal_splits(shape):
    """The rn128 split (mini-128, tpu_decompose) and the balanced split of
    a Qwen shape (hidden 896 -> 28 x 32, intermediate 8448 -> 88 x 96)."""
    kw = MINI if shape == "mini-128" else MINI_QWEN
    rn128 = shape == "mini-128"
    want = from_jax_fq(_np(j_init_model_fq(
        JLlamaConfig(**kw),
        dataclasses.replace(J_W4A4KV4, tpu_decompose=rn128), seed=3)), "cpu")
    got = init_model_fq(LlamaConfig(**kw), dataclasses.replace(
        W4A4KV4, tpu_decompose=rn128), seed=3, device="cpu")
    for i, (g, w) in enumerate(zip(got, want)):
        _same_tree(g, w, f"layer {i}")
    left = got[0].mlp.down_trans.left.u
    assert left.shape[0] == (4 if rn128 else 88)


def test_init_model_fq_tp_raises_naming_item_9():
    """tp > 1 (shard-aligned transforms) is ported since the parallel
    slice (bit-equal to JAX's, tests/test_torch_serving_tp.py); a tp that
    does not divide the heads and the intermediate is refused."""
    fq = init_model_fq(get_config("tiny-llama"), W4A4KV4, tp=2,
                       device="cpu")
    assert fq[0].attn.o_trans.size == get_config("tiny-llama").num_heads // 2
    with pytest.raises(ValueError, match="tp=3"):
        init_model_fq(get_config("tiny-llama"), W4A4KV4, tp=3, device="cpu")


# ---------------------------------------------------------------------------
# factors
# ---------------------------------------------------------------------------


def _cayley64(x):
    a = np.tril(np.asarray(x, np.float64), -1)
    a = a - a.T
    eye = np.eye(a.shape[0])
    return np.linalg.solve(eye - a / 2, eye + a / 2), np.linalg.cond(
        eye - a / 2)


@pytest.mark.parametrize("n", [8, 32, 128])
def test_cayley_matches_jax(n):
    rng = np.random.default_rng(n)
    for _ in range(3):
        x = jorth.random_cayley_param(n, rng)
        ref, cond = _cayley64(x)
        want = np.asarray(jorth.cayley(jnp.asarray(x)))
        got = torth.cayley(torch.from_numpy(x)).numpy()
        bound = cond * EPS32
        assert np.abs(want - ref).max() <= bound
        assert np.abs(got - ref).max() <= bound
        assert np.abs(got - want).max() <= max(bound, 1e-5), (n, cond)
        np.testing.assert_allclose(got @ got.T, np.eye(n), atol=10 * bound)
    q = jorth.random_orthogonal(n, rng)
    np.testing.assert_allclose(torth.inverse_cayley(q),
                               jorth.inverse_cayley(q), rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["svd", "inv"])
@pytest.mark.parametrize("inv_t", [False, True])
def test_factor_matrix_matches_jax(kind, inv_t):
    rng = np.random.default_rng(11)
    n = 32
    if kind == "svd":
        u, v = (jorth.random_cayley_param(n, rng) for _ in range(2))
        d = (1.0 + 0.2 * rng.normal(size=n)).astype(np.float32)
        jf = jtr.SVDFactor(jnp.asarray(u), jnp.asarray(v), jnp.asarray(d))
        tf = ttr.SVDFactor(*(torch.from_numpy(a) for a in (u, v, d)))
        bound = (_cayley64(u)[1] + _cayley64(v)[1]) * EPS32 * np.abs(
            1 / d if inv_t else d).max()
    else:
        m = (jorth.random_orthogonal(n, rng)
             + 0.05 * rng.normal(size=(n, n))).astype(np.float32)
        jf, tf = jtr.InvFactor(jnp.asarray(m)), ttr.InvFactor(
            torch.from_numpy(m))
        bound = 1e-5
    want = np.asarray(jtr.factor_matrix(jf, inv_t))
    got = ttr.factor_matrix(tf, inv_t).numpy()
    assert np.abs(got - want).max() <= max(bound, 1e-5)


def test_newton_inv_matches_jax():
    rng = np.random.default_rng(5)
    m = (np.eye(48) + 0.1 * rng.normal(size=(48, 48))).astype(np.float32)
    want = np.asarray(jtr._newton_inv(jnp.asarray(m)))
    got = ttr._newton_inv(torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got @ m, np.eye(48), atol=1e-5)


@pytest.mark.parametrize("perm", [False, True])
@pytest.mark.parametrize("inv_t", [False, True])
def test_apply_decompose_and_kron_forms_match_jax(perm, inv_t):
    """kronecker_matmul / _perm and kron_dense, through apply_decompose
    with a diag (tiled across two blocks) and inv_t."""
    rng = np.random.default_rng(2)
    ln, rn = 3, 8
    mats = [jorth.random_orthogonal(k, rng).astype(np.float32)
            for k in (ln, rn, ln, rn)]
    diag = (1 + 0.3 * rng.normal(size=ln * rn)).astype(np.float32)
    x = rng.normal(size=(5, 2 * ln * rn)).astype(np.float32)
    jt = jtr.BakedDecompose(*(jnp.asarray(a) for a in mats),
                            diag_scale=jnp.asarray(diag), perm=perm)
    tt = ttr.BakedDecompose(*(torch.from_numpy(a) for a in mats),
                            diag_scale=torch.from_numpy(diag), perm=perm)
    want = np.asarray(jtr.apply_decompose(jt, jnp.asarray(x), inv_t=inv_t))
    got = ttr.apply_decompose(tt, torch.from_numpy(x), inv_t=inv_t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    dense = tkron.kron_dense(torch.from_numpy(mats[0]),
                             torch.from_numpy(mats[1])).numpy()
    np.testing.assert_array_equal(dense, np.asarray(jkron.kron_dense(
        jnp.asarray(mats[0]), jnp.asarray(mats[1]))))


# ---------------------------------------------------------------------------
# bake
# ---------------------------------------------------------------------------


def _frozen(js, n):
    """JAX's transforms frozen layer by layer (bake_layer_fq), converted."""
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        j_bake_layer_fq(slice_layer(js, i)) for i in range(n)])
    return from_jax_fq(_np(stacked), "cpu")


def _max_rel(got_layers, want_layers):
    worst = 0.0
    for g, w in zip(got_layers, want_layers):
        for k in w:
            d = (g[k] - w[k]).abs().max() / w[k].abs().max().clamp_min(1e-30)
            worst = max(worst, d.item())
    return worst


def test_bake_model_matches_jax(mini):
    cfg, fq = mini["cfg"], mini["fq"]
    bp, bf = tbake.bake_model(cfg, fq, mini["tp"],
                              _frozen(mini["js"], cfg.num_layers))
    assert _max_rel(bp["layers"], mini["tbp"]["layers"]) <= 1e-5
    for g, w in zip(bf, mini["tbf"]):
        _same_tree(g, w)  # diag scales folded (None), matrices as frozen
    own, _ = tbake.bake_model(cfg, fq, mini["tp"], init_model_fq(
        cfg, fq, seed=0, device="cpu"))
    assert _max_rel(own["layers"], mini["tbp"]["layers"]) <= 5e-4


# ---------------------------------------------------------------------------
# build_serving_params
# ---------------------------------------------------------------------------


def _projections(layer):
    return [k for k, v in layer.items() if isinstance(v, dict)]


def _j_build(mini, layout, dtype=jnp.float32, **kw):
    return from_jax_serving_params(_np(j_build_serving_params(
        mini["jcfg"], mini["jfq"], mini["jbp"], mini["jbf"], dtype=dtype,
        **LAYOUTS[layout], **kw)), "cpu")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_build_serving_params_layouts_byte_equal(mini, layout):
    """The port's packer on JAX's baked params and baked FQ state:
    byte-equal to JAX's build in each layout, the same keys."""
    want = _j_build(mini, layout)
    got = build_serving_params(mini["cfg"], mini["fq"], mini["tbp"],
                               mini["tbf"], dtype=torch.float32,
                               **LAYOUTS[layout])
    for g, w in zip(got["layers"], want["layers"]):
        assert set(g) == set(w), set(g) ^ set(w)
        for key, val in w.items():
            if isinstance(val, dict):
                for part in ("wp", "scale"):
                    assert torch.equal(g[key][part], val[part]), (key, part)
                for a, b in zip(g[key]["a_clip"], val["a_clip"]):
                    assert torch.equal(a, b), key
            elif isinstance(val, tuple):
                for a, b in zip(g[key], val):
                    assert torch.equal(a, b), key
            else:
                assert torch.equal(g[key], val), key


def test_rtn_and_eval_params_match_jax(mini):
    """rtn_quantize_params bit for bit, and build_serving_params with
    eval_params (its on-grid weights): the codes come from them, the
    scales from the baked weights, as in JAX."""
    jev = jbake.rtn_quantize_params(mini["jfq"], mini["jbp"])
    tev = tbake.rtn_quantize_params(mini["fq"], mini["tbp"])
    for g, w in zip(tev["layers"], from_jax_params(_np(jev),
                                                   "cpu")["layers"]):
        for k in w:
            assert torch.equal(g[k], w[k]), k
    want = from_jax_serving_params(_np(j_build_serving_params(
        mini["jcfg"], mini["jfq"], mini["jbp"], mini["jbf"],
        dtype=jnp.float32, eval_params=jev)), "cpu")
    got = build_serving_params(
        mini["cfg"], mini["fq"], mini["tbp"], mini["tbf"],
        dtype=torch.float32, eval_params=tev)
    for g, w in zip(got["layers"], want["layers"]):
        for key in _projections(w):
            assert torch.equal(g[key]["wp"], w[key]["wp"]), key
            assert torch.equal(g[key]["scale"], w[key]["scale"]), key


def _codes_and_values(layer, baked, key):
    """(int codes, the pre-rounding values w / scale) of one packed
    projection from its baked weights (JAX's merge order)."""
    src = {"qkv": ("wq", "wk", "wv"), "upgate": ("wup", "wgate"),
           "q": ("wq",), "k": ("wk",), "v": ("wv",), "up": ("wup",),
           "gate": ("wgate",), "o": ("wo",), "down": ("wdown",)}[key]
    w = torch.cat([baked[k] for k in src])
    codes = unpack_weight_planar(layer[key]["wp"]).to(torch.int32)
    return codes, w / layer[key]["scale"][:, None]


@pytest.mark.parametrize("state", ["frozen", "own"])
@pytest.mark.parametrize("layout", ["merged", "unmerged"])
def test_build_chain_codes_differ_only_at_ties(mini, state, layout):
    """The port's whole chain against JAX's: from JAX's frozen transforms
    (the port's bake and pack) or from the port's own FQ state (its
    Cayley solves too). A code differs only where the two chains'
    pre-rounding values straddle a rounding tie, by one code; the count
    is stated in the message."""
    cfg, fq = mini["cfg"], mini["fq"]
    start = (_frozen(mini["js"], cfg.num_layers) if state == "frozen"
             else init_model_fq(cfg, fq, seed=0, device="cpu"))
    bp, bf = tbake.bake_model(cfg, fq, mini["tp"], start)
    got = build_serving_params(cfg, fq, bp, bf, dtype=torch.float32,
                               **LAYOUTS[layout])
    want = _j_build(mini, layout)
    flips = total = 0
    for i, (g, w) in enumerate(zip(got["layers"], want["layers"])):
        for key in _projections(w):
            cg, vg = _codes_and_values(g, bp["layers"][i], key)
            cw, vw = _codes_and_values(w, mini["tbp"]["layers"][i], key)
            assert torch.equal(cw, torch.clamp(torch.round(vw), -8, 7))
            near = (vg - vw).abs().max().item()
            assert near <= 2e-3, (key, near)
            diff = cg != cw
            if diff.any():
                assert (cg - cw)[diff].abs().max() == 1, key
                lo = torch.minimum(vg, vw)[diff]
                hi = torch.maximum(vg, vw)[diff]
                tie = torch.floor(hi + 0.5) - 0.5  # the .5 between them
                assert ((lo <= tie) & (tie <= hi)).all(), key
            flips += int(diff.sum())
            total += diff.numel()
    assert flips <= 1e-3 * total, f"{flips} of {total} codes differ"


# ---------------------------------------------------------------------------
# serving the unmerged and perm layouts
# ---------------------------------------------------------------------------


B, S, MAX_LEN = 2, 32, 128


@pytest.mark.parametrize("layout", ["unmerged", "perm"])
def test_engine_layouts_match_jax_kernels_f32(mini, layout):
    """JAX's packed params in the layout, converted, through the port's
    int4 engine and JAX's (use_kernel=True: its Pallas kernels in
    interpret mode): prefill, two scalar and two per-slot decode steps
    teacher-forced with JAX's greedy tokens."""
    jcfg, jfq, cfg, fq = mini["jcfg"], mini["jfq"], mini["cfg"], mini["fq"]
    jsp = j_build_serving_params(jcfg, jfq, mini["jbp"], mini["jbf"],
                                 dtype=jnp.float32, **LAYOUTS[layout])
    tsp = from_jax_serving_params(_np(jsp), "cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    jc = je.init_cache(jcfg, B, MAX_LEN, mode="int4")
    tc = te.init_cache(cfg, B, MAX_LEN, mode="int4", device="cpu")
    jlg, jc = je.serving_prefill(jcfg, jfq, jsp, jnp.asarray(toks), jc,
                                 max_len=MAX_LEN, compute_dtype=jnp.float32)
    tlg, tc = te.serving_prefill(cfg, fq, tsp, toks, tc, max_len=MAX_LEN,
                                 compute_dtype=torch.float32, device="cpu")
    steps = [(np.asarray(jlg), tlg.numpy())]
    ragged = np.array([S + 2, S - 1], np.int32)
    for pos in [S, S + 1, ragged, ragged + 1]:
        tok = steps[-1][0].argmax(-1)[:, None].astype(np.int32)
        tpos = torch.as_tensor(pos) if isinstance(pos, np.ndarray) else pos
        jlg, jc = je.serving_decode_step(
            jcfg, jfq, jsp, jnp.asarray(tok), jc, jnp.asarray(pos, jnp.int32),
            max_len=MAX_LEN, compute_dtype=jnp.float32)
        tlg, tc = te.serving_decode_step(cfg, fq, tsp, tok, tc, tpos,
                                         max_len=MAX_LEN,
                                         compute_dtype=torch.float32,
                                         device="cpu")
        steps.append((np.asarray(jlg), tlg.numpy()))
    for i, (jv, tv) in enumerate(steps):
        np.testing.assert_allclose(tv, jv, atol=1e-4, rtol=0,
                                   err_msg=f"{layout} step {i}")
        np.testing.assert_array_equal(tv.argmax(-1), jv.argmax(-1))


@pytest.mark.parametrize("layout", ["unmerged", "perm"])
def test_fused_routes_decline_unmerged_and_perm(mini, layout, monkeypatch):
    """At 256 prompt rows with use_kernel, JAX's fused routes key on ln_t,
    down_t and the merged qkv: the unmerged and perm layouts take the
    composed routes in both packages (the port's prefill equals its own
    use_kernel=False prefill, and JAX's at 1e-4)."""
    from flatquant_torch.kernels import flat_pipeline

    cfg, fq = mini["cfg"], mini["fq"]
    tsp = build_serving_params(cfg, fq, mini["tbp"], mini["tbf"],
                               dtype=torch.float32, **LAYOUTS[layout])
    called = []
    for name in ("rmsnorm_right_flat", "left_quant_i8_flat",
                 "w4a4_matmul_i8_swiglu_right"):
        monkeypatch.setattr(flat_pipeline, name, lambda *a, _n=name, **k: (
            called.append(_n)))
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 256))
    run = [te.serving_prefill(cfg, fq, tsp, toks, te.init_cache(
        cfg, 1, 384, mode="int4", device="cpu"), use_kernel=uk,
        max_len=384, compute_dtype=torch.float32, device="cpu")[0]
        for uk in (True, False)]
    assert not called
    assert torch.equal(run[0], run[1])


def test_batcher_serves_perm_unmerged_as_generate(mini):
    """The continuous batcher takes the perm + unmerged layout (per-slot
    decode over the int4 cache): each request's tokens equal a lone
    generate of its prompt."""
    cfg, fq = mini["cfg"], mini["fq"]
    tsp = build_serving_params(cfg, fq, mini["tbp"], mini["tbf"],
                               dtype=torch.float32,
                               **LAYOUTS["perm-unmerged"])
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (9, 20)]
    tb = ContinuousBatcher(cfg, fq, tsp, batch_slots=2, max_len=MAX_LEN,
                           compute_dtype=torch.float32, cache_mode="int4",
                           device="cpu")
    rids = [tb.submit(p, 5) for p in prompts]
    out = tb.run()
    for rid, p in zip(rids, prompts):
        want = te.generate(cfg, fq, tsp, p[None], max_new_tokens=5,
                           max_len=MAX_LEN, use_kernel=False,
                           cache_mode="int4", compute_dtype=torch.float32,
                           device="cpu")
        assert list(out[rid]) == list(want[0])


# ---------------------------------------------------------------------------
# the Llama forward modes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jcfg, cfg = j_get_config("tiny-llama"), get_config("tiny-llama")
    jp = jl.init_params(jcfg, seed=0)
    jp["lm_head"] = jp["lm_head"] * 6.0
    js = j_init_model_fq(jcfg, J_W4A4KV4, seed=0)
    jbp, jbf = jbake.bake_model(jcfg, J_W4A4KV4, jp, js)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, js=js, jbp=jbp, jbf=jbf,
                toks=toks)


@pytest.mark.parametrize("mode", ["fp", "calib", "eval"])
def test_llama_forward_matches_jax(tiny, mode):
    jcfg, cfg = tiny["jcfg"], tiny["cfg"]
    if mode == "eval":
        jparams, jfq = tiny["jbp"], tiny["jbf"]
    else:
        jparams, jfq = tiny["jp"], (tiny["js"] if mode == "calib" else None)
    want = np.asarray(jl.llama_forward(
        jcfg, jparams, jnp.asarray(tiny["toks"]), fq=jfq, fq_cfg=J_W4A4KV4,
        mode=mode, compute_dtype=jnp.float32))
    got = tl.llama_forward(
        cfg, from_jax_params(_np(jparams), "cpu"), tiny["toks"],
        fq=None if jfq is None else from_jax_fq(_np(jfq), "cpu"),
        fq_cfg=W4A4KV4, mode=mode, compute_dtype=torch.float32).numpy()
    assert got.shape == (2, 16, cfg.vocab_size)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_llama_layer_stats_and_captures_match_jax(tiny):
    """with_stats (fp) and with_linear_inputs (eval) return JAX's
    per-channel absmax and linear inputs; hidden_states_fn JAX's
    embedding, rope tables and mask."""
    jcfg, cfg = tiny["jcfg"], tiny["cfg"]
    jx, jcos, jsin, jmask = jl.hidden_states_fn(
        jcfg, tiny["jp"], jnp.asarray(tiny["toks"]),
        compute_dtype=jnp.float32)
    tp = from_jax_params(_np(tiny["jp"]), "cpu")
    tx, tcos, tsin, tmask = tl.hidden_states_fn(cfg, tp, tiny["toks"],
                                                compute_dtype=torch.float32)
    for g, w in ((tx, jx), (tcos, jcos), (tsin, jsin), (tmask, jmask)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    lp = {k: v[0] for k, v in tiny["jp"]["layers"].items()}
    _, jstats = jax.jit(lambda x: jl.llama_layer(
        jcfg, None, "fp", lp, None, x, jcos, jsin, jmask,
        with_stats=True))(jx)
    _, tstats = tl.llama_layer(cfg, None, "fp", tp["layers"][0], None, tx,
                               tcos, tsin, tmask, with_stats=True)
    blp = {k: v[0] for k, v in tiny["jbp"]["layers"].items()}
    _, jcap = jax.jit(lambda x: jl.llama_layer(
        jcfg, J_W4A4KV4, "eval", blp, slice_layer(tiny["jbf"], 0), x, jcos,
        jsin, jmask, with_linear_inputs=True))(jx)
    _, tcap = tl.llama_layer(
        cfg, W4A4KV4, "eval", from_jax_params(_np(tiny["jbp"]),
                                              "cpu")["layers"][0],
        from_jax_fq(_np(tiny["jbf"]), "cpu")[0], tx, tcos, tsin, tmask,
        with_linear_inputs=True)
    for got, want in ((tstats, jstats), (tcap, jcap)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)


def test_llama_attn_fn_raises_naming_item_9(tiny):
    """attn_fn is ported since the parallel slice (ring attention,
    tests/test_torch_sequence.py): a replacement attention core that
    computes the eager core's function gives the same logits, and is
    called once per layer."""
    params = from_jax_params(_np(tiny["jp"]), "cpu")
    S = np.asarray(tiny["toks"]).shape[1]
    mask = tl.causal_mask(S, "cpu")
    calls = []

    def attn(q, k, v):
        calls.append(q.shape)
        return tl._attention_core(tiny["cfg"], q, k, v, mask)

    want = tl.llama_forward(tiny["cfg"], params, tiny["toks"])
    got = tl.llama_forward(tiny["cfg"], params, tiny["toks"], attn_fn=attn)
    assert len(calls) == tiny["cfg"].num_layers
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# converters
# ---------------------------------------------------------------------------


def test_from_jax_round_trips_exact(mini):
    """from_jax_params and from_jax_fq (raw and baked, the perm flag
    carried) give the JAX values unchanged."""
    for jtree, ttree in ((mini["jp"], mini["tp"]),
                         (mini["jbp"], mini["tbp"])):
        for k, v in jtree["layers"].items():
            for i in range(2):
                np.testing.assert_array_equal(
                    ttree["layers"][i][k].numpy(), np.asarray(v[i]))
        for k in ("embed", "final_norm_w", "lm_head"):
            np.testing.assert_array_equal(ttree[k].numpy(),
                                          np.asarray(jtree[k]))
    for jfq in (mini["js"], mini["jbf"]):
        conv = from_jax_fq(_np(jfq), "cpu")
        paths = jax.tree_util.tree_flatten_with_path(_np(jfq))[0]
        for path, leaf in paths:
            for i in range(2):
                node = conv[i]
                for p in path:
                    node = getattr(node, p.name)
                np.testing.assert_array_equal(node.numpy(), leaf[i])
    perm = from_jax_fq(_np(jax.tree.map(
        lambda *xs: jnp.stack(xs), *[jtr.bake_decompose(
            slice_layer(mini["jbf"], i).attn.ln_trans, perm=True)
            for i in range(2)])), "cpu")
    assert isinstance(perm[0], ttr.BakedDecompose) and perm[0].perm
