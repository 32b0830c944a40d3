"""The port's eval modules (evals/tasks.py, evals/flatness.py) and the
Llama options no earlier test reached (Llama-3.1 rope scaling, tied
embeddings) against the JAX package, on the CPU, in float32.

Models: `tiny-llama` W4A4KV4 (JAX's random weights and baked state in
both packages, lm_head sharpened so no greedy ties), a Llama-3.1-shaped
mini config (rope scaling, GQA 2/1, head_dim 128) and `tiny-qwen` (tied
embeddings, qkv bias).

Tolerances, and why:
  - batched_loglikelihood, fake-quant ("eval" mode) and serving
    (serving_all_logits): sums within 1e-4 absolute and every greedy
    flag equal; float32 forwards summed in other orders (measured
    3.8e-6 on both paths).
  - batched_generate, the adapter's generate_until: tokens and strings
    equal (greedy over the same float32 logits).
  - the adapter's loglikelihood: within 1e-4 of JAX's adapter on the
    same requests (both scoring in float32; in the adapters' default bf16
    the packages' serving forwards round apart, 0.12 on a 2-token sum
    here), through a mocked lm_eval.api as tests/test_lm_eval_adapter.py
    mocks it.
  - flatness norms: 1e-5 relative (float32 norms and the Hadamard
    einsum summed in other orders, the transforms' Cayley solves).
  - rope tables: 1e-6 absolute (both from float64 inverse frequencies
    rounded once to float32; cos / sin of float32 angles differ by an
    ulp); logits within 1e-4 (float32).
  - tied embeddings: forward logits within 1e-4; the packed lm_head and
    embed equal to JAX's byte for byte, and the head is the embedding.
"""

import dataclasses
import sys
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flatquant_tpu.evals import flatness as jfl
from flatquant_tpu.evals import tasks as jtasks
from flatquant_tpu.models import llama as jl
from flatquant_tpu.models.config import LlamaConfig as JLlamaConfig
from flatquant_tpu.models.config import RopeScaling as JRopeScaling
from flatquant_tpu.models.config import get_config as j_get_config
from flatquant_tpu.quantize.bake import bake_model as j_bake_model
from flatquant_tpu.quantize.spec import W4A4KV4 as J_W4A4KV4
from flatquant_tpu.quantize.state import init_model_fq as j_init_model_fq
from flatquant_tpu.serving.quantized import (
    build_serving_params as j_build_serving_params,
)
from flatquant_torch.evals import flatness as tfl
from flatquant_torch.evals import tasks as ttasks
from flatquant_torch.models import llama as tl
from flatquant_torch.models.config import LlamaConfig, RopeScaling
from flatquant_torch.models.config import get_config
from flatquant_torch.quantize.bake import bake_model
from flatquant_torch.quantize.spec import W4A4KV4
from flatquant_torch.quantize.state import init_model_fq
from flatquant_torch.serving.quantized import build_serving_params
from flatquant_torch.utils.convert import (
    from_jax_fq,
    from_jax_params,
    from_jax_serving_params,
)

torch.set_num_threads(2)

MAX_LEN = 32
# (context, continuation) lengths: an empty context, one cut to max_len
PAIR_LENS = [(0, 3), (5, 1), (12, 6), (20, 2), (3, 9), (40, 4)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _j_bake(jcfg, jp, js):
    return jax.jit(lambda p, s: j_bake_model(jcfg, J_W4A4KV4, p, s))(jp, js)


@pytest.fixture(scope="module")
def served():
    jcfg, cfg = j_get_config("tiny-llama"), get_config("tiny-llama")
    jp = jl.init_params(jcfg, seed=0)
    jp["lm_head"] = jp["lm_head"] * 6.0
    js = j_init_model_fq(jcfg, J_W4A4KV4, seed=0)
    jbp, jbf = _j_bake(jcfg, jp, js)
    jsp = jax.jit(lambda p, f: j_build_serving_params(
        jcfg, J_W4A4KV4, p, f, dtype=jnp.float32))(jbp, jbf)
    rng = np.random.default_rng(11)
    pairs = [(rng.integers(0, cfg.vocab_size, c).tolist(),
              rng.integers(0, cfg.vocab_size, n).tolist())
             for c, n in PAIR_LENS]
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, js=js, jbp=jbp, jbf=jbf, jsp=jsp,
                tbp=from_jax_params(_np(jbp), "cpu"),
                tbf=from_jax_fq(_np(jbf), "cpu"),
                tsp=from_jax_serving_params(_np(jsp), "cpu"), pairs=pairs)


def _both_ll(s, path, pairs, **kw):
    serving = path == "serving"
    want = jtasks.batched_loglikelihood(
        s["jcfg"], s["jbp"], s["jbf"], J_W4A4KV4, "eval", pairs,
        compute_dtype=jnp.float32,
        serving_params=s["jsp"] if serving else None, **kw)
    got = ttasks.batched_loglikelihood(
        s["cfg"], s["tbp"], s["tbf"], W4A4KV4, "eval", pairs,
        compute_dtype=torch.float32,
        serving_params=s["tsp"] if serving else None, **kw)
    return got, want


@pytest.mark.parametrize("path", ["fake_quant", "serving"])
def test_batched_loglikelihood_matches_jax(served, path):
    got, want = _both_ll(served, path, served["pairs"], batch_size=4,
                         max_len=MAX_LEN)
    assert len(got) == len(want) == len(PAIR_LENS)
    for (a, ag), (b, bg) in zip(got, want):
        assert np.isfinite(a) and abs(a - b) <= 1e-4, (a, b)
        assert ag == bg


def test_batched_loglikelihood_context_rule(served):
    """A continuation that fills max_len leaves no context: both raise."""
    pair = [([1, 2], list(range(MAX_LEN)))]
    for fn, args in ((jtasks.batched_loglikelihood,
                      (served["jcfg"], served["jbp"], served["jbf"],
                       J_W4A4KV4)),
                     (ttasks.batched_loglikelihood,
                      (served["cfg"], served["tbp"], served["tbf"],
                       W4A4KV4))):
        with pytest.raises(ValueError, match="no context within max_len"):
            fn(*args, "eval", pair, max_len=MAX_LEN)


def test_batched_generate_matches_jax(served):
    prompts = [list(range(3, 20)), [7, 9, 11], list(range(40, 69))]
    stops = [[[5]], [], [[1, 2]]]
    kw = dict(max_new_tokens=5, max_len=64, stop_token_sets=stops)
    want = jtasks.batched_generate(served["jcfg"], J_W4A4KV4, served["jsp"],
                                   prompts, **kw)
    got = ttasks.batched_generate(served["cfg"], W4A4KV4, served["tsp"],
                                  prompts, **kw)
    assert got == want
    assert all(len(t) <= 5 for t in got)


class _CharTokenizer:
    """Char-level toy tokenizer over the tiny model's 256-id vocab."""

    eos_token_id = None

    def encode(self, s):
        return [ord(c) % 256 for c in s]

    def decode(self, ids):
        return "".join(chr(int(i) % 128) for i in ids)


@pytest.fixture()
def mock_lm_eval():
    """The lm_eval surface the adapters import, as mock modules."""
    pkg = types.ModuleType("lm_eval")
    api = types.ModuleType("lm_eval.api")
    model = types.ModuleType("lm_eval.api.model")
    instance = types.ModuleType("lm_eval.api.instance")

    class LM:
        def __init__(self):
            pass

    class Instance:
        def __init__(self, args):
            self.args = args

    model.LM, instance.Instance = LM, Instance
    pkg.api, api.model, api.instance = api, model, instance
    mods = {"lm_eval": pkg, "lm_eval.api": api, "lm_eval.api.model": model,
            "lm_eval.api.instance": instance}
    saved = {k: sys.modules.get(k) for k in mods}
    sys.modules.update(mods)
    yield Instance
    for k, v in saved.items():
        if v is None:
            sys.modules.pop(k, None)
        else:
            sys.modules[k] = v


@pytest.fixture()
def float32_scores(monkeypatch):
    """Both adapters score in float32 (their batched_loglikelihood runs
    the default bf16, where the two packages' forwards round apart)."""
    for mod, dt in ((jtasks, jnp.float32), (ttasks, torch.float32)):
        def f32(*a, _orig=mod.batched_loglikelihood, _dt=dt, **k):
            return _orig(*a, compute_dtype=_dt, **k)

        monkeypatch.setattr(mod, "batched_loglikelihood", f32)


def test_lm_eval_adapter_matches_jax(mock_lm_eval, served, float32_scores):
    Instance, s, tok = mock_lm_eval, served, _CharTokenizer()
    jlm = jtasks.make_lm_eval_adapter(
        s["jcfg"], s["jbp"], s["jbf"], J_W4A4KV4, "eval", tok, batch_size=4,
        serving_params=s["jsp"], max_gen_tokens=8)
    tlm = ttasks.make_lm_eval_adapter(
        s["cfg"], s["tbp"], s["tbf"], W4A4KV4, "eval", tok, batch_size=4,
        serving_params=s["tsp"], max_gen_tokens=8)
    reqs = [Instance((c, t)) for c, t in (("the quick brown", " fox"),
                                          ("hello wor", "ld"),
                                          ("abcde", "fg"))]
    for (a, ag), (b, bg) in zip(tlm.loglikelihood(reqs),
                                jlm.loglikelihood(reqs)):
        assert abs(a - b) <= 1e-4 and ag == bg
    roll = [Instance(("hello there",))]
    (ra,), (rb,) = tlm.loglikelihood_rolling(roll), jlm.loglikelihood_rolling(
        roll)
    assert abs(ra[0] - rb[0]) <= 1e-4
    greq = [Instance(("abc", {"max_gen_toks": 4})),
            Instance(("hi", {"max_gen_toks": 2, "until": ["zz"]}))]
    outs = tlm.generate_until(greq)
    assert outs == jlm.generate_until(greq)
    assert len(outs[0]) <= 4 and len(outs[1]) <= 2


def test_lm_eval_adapter_raises_without_the_package(served):
    if "lm_eval" in sys.modules:
        pytest.skip("an lm_eval module is loaded")
    with pytest.raises(ImportError, match="lm-eval is not installed"):
        ttasks.make_lm_eval_adapter(served["cfg"], served["tbp"],
                                    served["tbf"], W4A4KV4, "eval",
                                    _CharTokenizer())


# ---------------------------------------------------------------------------
# flatness
# ---------------------------------------------------------------------------


def test_model_flatness_matches_jax_and_plots(served, tmp_path,
                                             monkeypatch):
    """tiny-llama with two outlier embedding channels and its raw W4A4KV4
    state (the port's own init_model_fq: JAX's bit for bit), layers 0 and
    1 (JAX's pieces jitted: op by op they take ~11 s)."""
    from flatquant_tpu.core import hadamard as jh
    from flatquant_tpu.core import transforms as jtr

    for name, fn in (("llama_layer", jax.jit(jl.llama_layer,
                                             static_argnums=(0, 1, 2))),
                     ("matmul_hadU", jax.jit(jh.matmul_hadU)),
                     ("apply_decompose", jax.jit(
                         jtr.apply_decompose, static_argnames=("inv_t",))),
                     ("_sq_diag", jax.jit(jfl._sq_diag))):
        monkeypatch.setattr(jfl, name, fn)
    jcfg, cfg = served["jcfg"], served["cfg"]
    jp = dict(served["jp"], embed=served["jp"]["embed"].at[:, :2].mul(20.0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 32))
    want = jfl.model_flatness(jcfg, jp, served["js"], jnp.asarray(toks),
                              layers=(0, 1))
    got = tfl.model_flatness(cfg, from_jax_params(_np(jp), "cpu"),
                             init_model_fq(cfg, W4A4KV4, seed=0,
                                           device="cpu"),
                             toks, layers=(0, 1))
    assert set(got) == set(want) == {0, 1}
    for layer in want:
        assert set(got[layer]) == set(want[layer]) == {
            "vanilla", "hadamard", "smoothquant", "flatquant"}
        for method, kinds in want[layer].items():
            for kind, w in kinds.items():
                g = got[layer][method][kind]
                assert g.dtype == np.float32 and g.shape == w.shape
                np.testing.assert_allclose(g, w, rtol=1e-5,
                                           err_msg=f"{layer} {method} {kind}")
    m = got[0]
    assert (m["hadamard"]["act"].max() / m["hadamard"]["act"].mean()
            < m["vanilla"]["act"].max() / m["vanilla"]["act"].mean())
    png = tfl.plot_flatness(got, str(tmp_path / "flat.png"))
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


# ---------------------------------------------------------------------------
# Llama-3.1 rope scaling and tied embeddings
# ---------------------------------------------------------------------------

MINI_31 = dict(name="mini-llama-3.1", vocab_size=128, hidden_size=256,
               intermediate_size=512, num_layers=2, num_heads=2,
               num_kv_heads=1, head_dim=128, rope_theta=500000.0,
               seqlen=64)


def test_rope_scaling_matches_jax():
    """llama-3.1-8b's rope (theta 5e5, factor 8, bands 1 / 4 over 8192
    positions) on a 2-layer mini config: the tables over positions up to
    8192 and the fp forward."""
    jcfg = JLlamaConfig(**MINI_31, rope_scaling=JRopeScaling())
    cfg = LlamaConfig(**MINI_31, rope_scaling=RopeScaling())
    assert get_config("llama-3.1-8b").rope_scaling == RopeScaling()
    pos = np.array([0, 1, 7, 100, 2047, 4096, 8191])
    jc, jsn = jl.rope_tables(jcfg, jnp.asarray(pos))
    tc, tsn = tl.rope_tables(cfg, torch.as_tensor(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(tsn.numpy(), np.asarray(jsn), atol=1e-6)
    plain = tl.rope_tables(dataclasses.replace(cfg, rope_scaling=None),
                           torch.as_tensor(pos))
    assert not torch.allclose(plain[0], tc)  # the scaling is in effect

    jp = jl.init_params(jcfg, seed=1)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24))
    want = jl.llama_forward(jcfg, jp, jnp.asarray(toks),
                            compute_dtype=jnp.float32)
    got = tl.llama_forward(cfg, from_jax_params(_np(jp), "cpu"), toks,
                           compute_dtype=torch.float32,
                           positions=torch.arange(4000, 4024))
    base = tl.llama_forward(cfg, from_jax_params(_np(jp), "cpu"), toks,
                            compute_dtype=torch.float32)
    np.testing.assert_allclose(base.numpy(), np.asarray(want), atol=1e-4)
    jfar = jl.llama_forward(jcfg, jp, jnp.asarray(toks),
                            compute_dtype=jnp.float32,
                            positions=jnp.arange(4000, 4024))
    np.testing.assert_allclose(got.numpy(), np.asarray(jfar), atol=1e-4)


def test_tied_embeddings_match_jax():
    """tiny-qwen (tie_embeddings, qkv bias): no lm_head in either
    package's params, the fp and eval forwards read the embedding as the
    head, and build_serving_params packs the embedding as lm_head."""
    jcfg, cfg = j_get_config("tiny-qwen"), get_config("tiny-qwen")
    assert cfg.tie_embeddings and cfg.attn_bias
    jp = jl.init_params(jcfg, seed=2)
    tp = from_jax_params(_np(jp), "cpu")
    assert "lm_head" not in jp and "lm_head" not in tp
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16))
    jfwd = jax.jit(jl.llama_forward, static_argnames=(
        "cfg", "fq_cfg", "mode", "compute_dtype"))
    np.testing.assert_allclose(
        tl.llama_forward(cfg, tp, toks, compute_dtype=torch.float32).numpy(),
        np.asarray(jfwd(cfg=jcfg, params=jp, tokens=jnp.asarray(toks),
                        compute_dtype=jnp.float32)), atol=1e-4)
    jbp, jbf = _j_bake(jcfg, jp, j_init_model_fq(jcfg, J_W4A4KV4, seed=2))
    jsp = from_jax_serving_params(_np(jax.jit(lambda p, f: (
        j_build_serving_params(jcfg, J_W4A4KV4, p, f)))(jbp, jbf)), "cpu")
    tbp, tbf = bake_model(cfg, W4A4KV4, tp,
                          init_model_fq(cfg, W4A4KV4, seed=2, device="cpu"))
    assert "lm_head" not in tbp
    tsp = build_serving_params(cfg, W4A4KV4, tbp, tbf)
    for key in ("embed", "lm_head"):
        assert tsp[key].dtype == jsp[key].dtype == torch.bfloat16
        assert torch.equal(tsp[key], jsp[key]), key
    assert torch.equal(tsp["lm_head"], tsp["embed"])
    np.testing.assert_allclose(
        tl.llama_forward(cfg, tbp, toks, fq=tbf, fq_cfg=W4A4KV4,
                         mode="eval", compute_dtype=torch.float32).numpy(),
        np.asarray(jfwd(cfg=jcfg, params=jbp, tokens=jnp.asarray(toks),
                        fq=jbf, fq_cfg=J_W4A4KV4, mode="eval",
                        compute_dtype=jnp.float32)), atol=1e-4)
