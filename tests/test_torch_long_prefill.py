"""Long prompts (S >= 1024) in the port against the JAX package, on the CPU.

Kernels: inputs made with numpy from a seed go through JAX's flash
kernels (their Pallas bodies in interpret mode, as the JAX package's own
tests run them) and through the port's wrappers, which on CPU tensors run
their plain versions: the Pallas body's rounding and blocking in plain
PyTorch. Engines: the 2-layer `mini-128` model (head_dim 128, rn128
Kronecker transforms, W4A4KV4 + tpu_decompose) built in JAX, served at
1 x 1024 (max_len 1152) through the int4-cache engine's fused route
(prologue + flash kt), the bf16-cache engine (serving_layer,
serving_all_logits, generate) and the bf16 comparator (serving/baseline.py).

Tolerances, and why:
  - float32: the blocking and rounding points are JAX's, only the float32
    sums run in another order: 2e-5 (tests/test_prefill_attention.py) on
    the kernels, 1e-4 on the int4 engine's logits of scale ~6 (lm_head
    sharpened 6x). At 1024 tokens those sums put a few activations per
    layer within 1e-6 of a W4A4 rounding tie, and a code that rounds apart
    in layer 0 reaches every later position of layer 1 through attention.
    So the bf16-cache engine and serving_all_logits run each layer from
    JAX's own input of that layer (`_layers_teacher_forced`) and hold
    every layer's output, cache and logits to 1e-4 but for the few rows a
    tie moves (`_close_up_to_ties`);
  - bf16 kernels: a float32 score or row sum one ulp apart can move a bf16
    output, or a bf16 p and through it the outputs of its row, by one ulp:
    outputs within one ulp of their own value on all but 0.1% of them, and
    every output within one ulp of the largest value of its (token, head)
    row (measured: 2e-4 of outputs beyond their own ulp);
  - the bf16 comparator: both sides round op by op (JAX under
    disable_jit); bf16 matmuls sum in another order, so an activation may
    round one ulp apart and carry through the layers (no quantization to
    amplify it): logits within 0.07, two bf16 ulps of the logit scale.
"""

import contextlib
import dataclasses
import inspect

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flatquant_tpu.kernels import prefill_attention as jpa
from flatquant_tpu.kernels.kv_cache import untranspose_kv as j_untranspose
from flatquant_tpu.models.config import LlamaConfig as JLlamaConfig
from flatquant_tpu.models.llama import init_params as j_init_params
from flatquant_tpu.models.llama import rope_tables as j_rope_tables
from flatquant_tpu.quantize.bake import bake_model
from flatquant_tpu.quantize.spec import W4A4KV4 as J_W4A4KV4
from flatquant_tpu.quantize.state import init_model_fq
from flatquant_tpu.serving import baseline as jb
from flatquant_tpu.serving import engine as je
from flatquant_tpu.serving.batcher import ContinuousBatcher as JBatcher
from flatquant_tpu.serving.quantized import (
    build_serving_params as j_build_serving_params,
)
from flatquant_torch.kernels import prefill_attention as tpa
from flatquant_torch.kernels.tolerance import bf16_ulp
from flatquant_torch.models.config import LlamaConfig
from flatquant_torch.models.llama import rope_tables
from flatquant_torch.quantize.spec import W4A4KV4
from flatquant_torch.serving import baseline as tb
from flatquant_torch.serving import engine as te
from flatquant_torch.serving.batcher import ContinuousBatcher
from flatquant_torch.utils.convert import from_jax_serving_params

torch.set_num_threads(2)

MINI = dict(name="mini-128", vocab_size=128, hidden_size=256,
            intermediate_size=512, num_layers=2, num_heads=2,
            num_kv_heads=2, head_dim=128, seqlen=256)
S_LONG, MAX_LEN = 1024, 1152  # MAX_LEN % 128 == 0: JAX's decode kernel


def _t(a):
    """numpy/JAX array -> torch CPU tensor (bf16 widened exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _check(got, want, dtype, what):
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=0, err_msg=what)
        return
    g, w = got.float(), _t(want).float()
    err = (g - w).abs()
    rowmax = w.abs().amax(dim=-1, keepdim=True)
    frac = (err > bf16_ulp(w)).double().mean().item()
    worst = (err / bf16_ulp(rowmax)).max().item()
    assert frac <= 1e-3 and worst <= 1.0, (what, frac, worst)


def _qkv(rng, B, S, nh, nkv, hd, dtype):
    arrs = [rng.standard_normal((B, S, n, hd)).astype(np.float32)
            for n in (nh, nkv, nkv)]
    return [jnp.asarray(a, dtype) for a in arrs]


# ---------------------------------------------------------------------------
# kernels: the plain versions against JAX's Pallas bodies (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["flash_prefill_attention",
                                   "flash_prefill_attention_kt"])
@pytest.mark.parametrize("S", [1024, 1152])
@pytest.mark.parametrize("hd", [128, 64])
@pytest.mark.parametrize("nh,nkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_wrapper_matches_jax(rng, entry, S, hd, nh, nkv, dtype):
    q, k, v = _qkv(rng, 1, S, nh, nkv, hd, dtype)
    sm = 1.0 / float(np.sqrt(hd))
    if entry == "flash_prefill_attention":
        want = jpa.flash_prefill_attention(q, k, v, sm, interpret=True)
        got = tpa.flash_prefill_attention(_t(q), _t(k), _t(v), sm)
    else:  # JAX's contiguous [B, nkv, hd, S] layout
        kt = jnp.transpose(k, (0, 2, 3, 1))
        want = jpa.flash_prefill_attention_kt(q, kt, v, sm, interpret=True)
        got = tpa.flash_prefill_attention_kt(_t(q), _t(kt), _t(v), sm)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    _check(got, want, dtype, entry)


def test_flash_kt_reads_a_token_major_view(rng):
    """The fused route passes the prologue's token-major k as a strided
    [B, nkv, hd, S] view: the same result as JAX's contiguous kt."""
    q, k, v = _qkv(rng, 2, 1024, 4, 2, 128, "bfloat16")
    kt = jnp.transpose(k, (0, 2, 3, 1))
    want = jpa.flash_prefill_attention_kt(q, kt, v, 0.088, interpret=True)
    view = _t(k).permute(0, 2, 3, 1)
    assert view.stride(2) == 1
    got = tpa.flash_prefill_attention_kt(_t(q), view, _t(v), 0.088)
    _check(got, want, "bfloat16", "kt view")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_prefill_ref_matches_jax(rng, dtype):
    q, k, v = _qkv(rng, 1, 1152, 8, 2, 64, dtype)
    want = jpa.flash_prefill_ref(q, k, v, 0.125)
    got = tpa.flash_prefill_ref(_t(q), _t(k), _t(v), 0.125)
    _check(got, want, dtype, "flash_prefill_ref")


@pytest.mark.parametrize("S,use_kernel,route", [
    (896, True, "dense"), (1000, True, "dense"), (1024, True, "flash"),
    (1152, False, "ref"), (1040, False, "dense")])
def test_prefill_attention_thresholds(rng, monkeypatch, S, use_kernel, route):
    """JAX's dispatch: dense below 1024 tokens or when S % 128 != 0, the
    flash kernel with use_kernel, else the blockwise oracle."""
    q, k, v = _qkv(rng, 1, S, 2, 1, 64, "float32")
    taken = []
    for name in ("dense_causal_attention", "flash_prefill_attention",
                 "flash_prefill_ref"):
        fn = getattr(tpa, name)
        monkeypatch.setattr(tpa, name, lambda *a, _n=name, _f=fn, **kw: (
            taken.append(_n), _f(*a, **kw))[1])
    got = tpa.prefill_attention(_t(q), _t(k), _t(v), 0.125, use_kernel,
                                torch.float32)
    want = jpa.prefill_attention(q, k, v, 0.125, use_kernel, jnp.float32)
    assert taken == [{"dense": "dense_causal_attention",
                      "flash": "flash_prefill_attention",
                      "ref": "flash_prefill_ref"}[route]]
    _check(got, want, "float32", f"S={S}")


def test_prefill_attention_signature_matches_jax():
    """prefill_attention takes JAX's parameters with JAX's defaults,
    flash_threshold=1024 among them (the port lacked it until the fault
    was fixed: a call that passed it raised TypeError)."""
    want = inspect.signature(jpa.prefill_attention).parameters
    got = inspect.signature(tpa.prefill_attention).parameters
    assert list(got) == list(want)
    for name in ("use_kernel", "flash_threshold"):
        assert got[name].default == want[name].default, name
    assert got["flash_threshold"].default == 1024


@pytest.mark.parametrize("S,threshold,route", [
    (256, 256, "ref"), (512, 2048, "dense"), (384, 128, "ref")])
def test_prefill_attention_flash_threshold_routes_as_jax(
        rng, monkeypatch, S, threshold, route):
    """A caller's flash_threshold moves the dense / flash edge in both
    packages alike (dense when S < flash_threshold or S % 128)."""
    q, k, v = _qkv(rng, 1, S, 2, 1, 64, "float32")
    taken = []
    for name in ("dense_causal_attention", "flash_prefill_ref"):
        fn = getattr(tpa, name)
        monkeypatch.setattr(tpa, name, lambda *a, _n=name, _f=fn, **kw: (
            taken.append(_n), _f(*a, **kw))[1])
    got = tpa.prefill_attention(_t(q), _t(k), _t(v), 0.125, False,
                                torch.float32, flash_threshold=threshold)
    want = jpa.prefill_attention(q, k, v, 0.125, False, jnp.float32,
                                 flash_threshold=threshold)
    assert taken == [{"dense": "dense_causal_attention",
                      "ref": "flash_prefill_ref"}[route]]
    _check(got, want, "float32", f"S={S} threshold={threshold}")


# ---------------------------------------------------------------------------
# engines at 1 x 1024 on mini-128
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    jcfg = JLlamaConfig(**MINI)
    jfq = dataclasses.replace(J_W4A4KV4, tpu_decompose=True)
    params = j_init_params(jcfg, seed=0)
    params["lm_head"] = params["lm_head"] * 6.0  # sharpen: no greedy ties
    bp, bfq = bake_model(jcfg, jfq, params, init_model_fq(jcfg, jfq, seed=0))
    sp = j_build_serving_params(jcfg, jfq, bp, bfq, dtype=jnp.float32,
                                merge_projections=True)
    jbp = jb.build_bf16_params(jcfg, params)
    return dict(jcfg=jcfg, jfq=jfq, sp=sp, jbp=jbp, cfg=LlamaConfig(**MINI),
                fq=dataclasses.replace(W4A4KV4, tpu_decompose=True),
                tsp=from_jax_serving_params(jax.tree.map(np.asarray, sp),
                                            device="cpu"),
                tbp=from_jax_serving_params(jax.tree.map(np.asarray, jbp),
                                         device="cpu"))


def _tokens(B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, MINI["vocab_size"], (B, S)).astype(np.int32)


@contextlib.contextmanager
def _count(module, names):
    """Count calls of module-level functions of `module`."""
    n = dict.fromkeys(names, 0)
    saved = {name: getattr(module, name) for name in names}

    def counting(name):
        def wrapped(*a, **kw):
            n[name] += 1
            return saved[name](*a, **kw)
        return wrapped

    for name in names:
        setattr(module, name, counting(name))
    try:
        yield n
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def _nibble_diff(a, b):
    a = np.asarray(a).astype(np.int32)
    b = np.asarray(b).astype(np.int32)
    return np.abs(np.stack([a & 0xF, a >> 4]) - np.stack([b & 0xF, b >> 4]))


def _run_engines(model, mode, n_decode, use_kernel=True, B=1, S=S_LONG,
                 slot=False):
    """Prefill and n_decode greedy steps (teacher-forced with JAX's tokens)
    through both engines in float32 with the given cache mode; slot=True
    makes the last step per-slot with ragged positions."""
    jcfg, jfq, cfg, fq = model["jcfg"], model["jfq"], model["cfg"], model["fq"]
    toks = _tokens(B, S)
    kw = dict(max_len=MAX_LEN, use_kernel=use_kernel)
    jc = je.init_cache(jcfg, B, MAX_LEN, dtype=jnp.float32, mode=mode)
    tc = te.init_cache(cfg, B, MAX_LEN, dtype=torch.float32, mode=mode,
                       device="cpu")
    jl, jc = je.serving_prefill(jcfg, jfq, model["sp"], jnp.asarray(toks), jc,
                                compute_dtype=jnp.float32, **kw)
    tl, tc = te.serving_prefill(cfg, fq, model["tsp"], toks, tc,
                                compute_dtype=torch.float32, device="cpu",
                                **kw)
    steps = [(np.asarray(jl), tl.numpy())]
    for i in range(n_decode):
        tok = steps[-1][0].argmax(-1)[:, None].astype(np.int32)
        pos = S + i
        if slot and i == n_decode - 1:
            pos = np.array([S + i, S + i - 3][:B], np.int32)
        jl, jc = je.serving_decode_step(jcfg, jfq, model["sp"],
                                        jnp.asarray(tok), jc,
                                        jnp.asarray(pos, jnp.int32),
                                        compute_dtype=jnp.float32, **kw)
        tl, tc = te.serving_decode_step(
            cfg, fq, model["tsp"], tok, tc,
            torch.as_tensor(pos) if slot and i == n_decode - 1 else pos,
            compute_dtype=torch.float32, device="cpu", **kw)
        steps.append((np.asarray(jl), tl.numpy()))
    return steps, jc, tc


def _check_steps(steps, atol=1e-4):
    for i, (jl, tl) in enumerate(steps):
        np.testing.assert_allclose(tl, jl, atol=atol, rtol=0,
                                   err_msg=f"step {i}")
        np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))


def test_int4_engine_long_prefill_matches_jax_f32(model):
    """The fused route at S = 1024: prologue, flash kt (one call per
    layer), the o path; then two decode steps over the prologue's cache."""
    with _count(te, ["flash_prefill_attention_kt", "attn_prologue"]) as n:
        steps, jc, tc = _run_engines(model, "int4", 2)
    assert n == {"flash_prefill_attention_kt": 2, "attn_prologue": 2}
    _check_steps(steps)
    for key, pkey in (("kp", "kparam"), ("vp", "vparam")):
        for i in range(model["cfg"].num_layers):
            pk, sc, _ = j_untranspose(jc[key][i], jc[pkey][i])
            d = _nibble_diff(pk, tc[key][i].numpy())
            assert d.max() <= 1 and (d > 0).mean() < 0.01, (key, i, d.max())
            np.testing.assert_allclose(tc[pkey][i][..., 0].numpy(),
                                       np.asarray(sc)[..., 0], rtol=1e-5)


@contextlib.contextmanager
def _layers_teacher_forced():
    """Record every call of JAX's serving_layer (input and output x) and
    run the port's serving_layer on JAX's input of the same call, recording
    its output: each layer of an entry point is then compared from the
    same input. (At S = 1024 a float32 sum taken in another order puts a
    few activations per layer within 1e-6 of a W4A4 rounding tie; a code
    that rounds apart at position j of layer 0 moves every later position
    of layer 1 through attention, so whole-model float32 logits cannot be
    held to 1e-4 position by position.)"""
    rec = {"jax": [], "port": []}
    j_layer, t_layer = je.serving_layer, te.serving_layer

    def j_wrapped(*a, **kw):
        out = j_layer(*a, **kw)
        rec["jax"].append((np.asarray(a[3]), np.asarray(out[0])))
        return out

    def t_wrapped(*a, **kw):
        x_in = torch.from_numpy(rec["jax"][len(rec["port"])][0].copy())
        out = t_layer(*a[:3], x_in, *a[4:], **kw)
        rec["port"].append(out.numpy())
        return out

    je.serving_layer, te.serving_layer = j_wrapped, t_wrapped
    try:
        yield rec
    finally:
        je.serving_layer, te.serving_layer = j_layer, t_layer


def _close_up_to_ties(got, want, what):
    """float32 rows (last axis) within 1e-4, but for the rows where a W4A4
    code rounds apart at a float32 tie, and the later rows that attention
    spreads such a code to: at most 10% of the rows beyond 1e-4, and
    every row within 5% of its norm (one code step of a 16-level
    quantizer moves its row by ~2%; a wrong mask, scale or layout moves
    every row by far more)."""
    got, want = np.asarray(got), np.asarray(want)
    d = np.abs(got - want).max(axis=-1)
    rel = (d / np.maximum(np.linalg.norm(want, axis=-1), 1e-30)).max()
    frac = (d > 1e-4).mean()
    assert frac <= 0.1 and rel <= 0.05, (what, frac, rel)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_bf16_cache_engine_long_prefill_matches_jax_f32(model, use_kernel):
    """serving_layer through serving_prefill / serving_decode_step over the
    bf16 cache (kv4 quantize -> dequantize at write), each layer from JAX's
    input (op by op); at S = 1024 prefill attention takes the flash kernel
    (use_kernel) or the blockwise oracle."""
    from flatquant_torch.kernels import prefill_attention as pa

    with _count(pa, ["flash_prefill_attention", "flash_prefill_ref"]) as n, \
            _layers_teacher_forced() as rec, jax.disable_jit():
        steps, jc, tc = _run_engines(model, "bf16", 2, use_kernel)
    L = model["cfg"].num_layers
    assert n == {"flash_prefill_attention": L if use_kernel else 0,
                 "flash_prefill_ref": 0 if use_kernel else L}
    assert len(rec["port"]) == len(rec["jax"]) == 3 * L
    for i, ((_, want), got) in enumerate(zip(rec["jax"], rec["port"])):
        _close_up_to_ties(got, want, f"layer call {i}")
    for i, (jl, tl) in enumerate(steps):
        _close_up_to_ties(tl, jl, f"logits, step {i}")
    for key in ("k", "v"):
        for i in range(L):
            _close_up_to_ties(tc[key][i].numpy(), np.asarray(jc[key][i]),
                              f"{key} cache, layer {i}")


def test_bf16_cache_engine_per_slot_decode_matches_jax_f32(model):
    """A short prompt (dense attention) and a per-slot decode step: the
    masked-select cache write at ragged positions."""
    steps, jc, tc = _run_engines(model, "bf16", 2, B=2, S=32, slot=True)
    _check_steps(steps)
    for key in ("k", "v"):
        for i in range(model["cfg"].num_layers):
            np.testing.assert_allclose(tc[key][i].numpy(),
                                       np.asarray(jc[key][i]), atol=1e-4,
                                       rtol=0)


def test_serving_layer_matches_jax_f32(model):
    """One serving_layer prefill at S = 1024 with the flash kernel, then a
    decode step: layer outputs and the written cache rows."""
    jcfg, jfq, cfg, fq = model["jcfg"], model["jfq"], model["cfg"], model["fq"]
    x = np.random.default_rng(3).standard_normal(
        (1, S_LONG, cfg.hidden_size)).astype(np.float32)
    jsl = jax.tree.map(lambda a: a[0], model["sp"]["layers"])
    tsl = model["tsp"]["layers"][0]
    jcos, jsin = j_rope_tables(jcfg, jnp.arange(MAX_LEN))
    cos, sin = rope_tables(cfg, torch.arange(MAX_LEN))
    shape = (1, MAX_LEN, cfg.num_kv_heads, cfg.head_dim)
    jck, jcv = jnp.zeros(shape), jnp.zeros(shape)
    tck, tcv = torch.zeros(shape), torch.zeros(shape)
    for phase, xs, pos in (("prefill", x, 0), ("decode", x[:, -1:], S_LONG)):
        jy, jck, jcv = je.serving_layer(jcfg, jfq, jsl, jnp.asarray(xs), jcos,
                                        jsin, jck, jcv, pos, phase, True,
                                        jnp.float32)
        ty = te.serving_layer(cfg, fq, tsl, torch.from_numpy(xs), cos, sin,
                              tck, tcv, pos, phase, True, torch.float32)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4,
                                   rtol=0, err_msg=phase)
    np.testing.assert_allclose(tck.numpy(), np.asarray(jck), atol=1e-4)
    np.testing.assert_allclose(tcv.numpy(), np.asarray(jcv), atol=1e-4)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_serving_all_logits_matches_jax_f32(model, use_kernel):
    """Full-sequence logits at S = 1024, each layer from JAX's input."""
    jcfg, jfq, cfg, fq = model["jcfg"], model["jfq"], model["cfg"], model["fq"]
    toks = _tokens(1, S_LONG, seed=4)
    with _layers_teacher_forced() as rec, jax.disable_jit():
        want = je.serving_all_logits(jcfg, jfq, model["sp"],
                                     jnp.asarray(toks), use_kernel=use_kernel,
                                     compute_dtype=jnp.float32)
        got = te.serving_all_logits(cfg, fq, model["tsp"], toks,
                                    use_kernel=use_kernel,
                                    compute_dtype=torch.float32, device="cpu")
    assert got.shape == (1, S_LONG, cfg.vocab_size)
    assert len(rec["port"]) == len(rec["jax"]) == cfg.num_layers
    for i, ((_, jy), ty) in enumerate(zip(rec["jax"], rec["port"])):
        _close_up_to_ties(ty, jy, f"layer {i}")
    _close_up_to_ties(got.numpy(), want, "logits")


def test_generate_bf16_cache_matches_jax(model):
    jcfg, jfq, cfg, fq = model["jcfg"], model["jfq"], model["cfg"], model["fq"]
    prompt = _tokens(1, S_LONG, seed=5)
    want = je.generate(jcfg, jfq, model["sp"], prompt, max_new_tokens=2,
                       max_len=MAX_LEN, use_kernel=True, cache_mode="bf16",
                       compute_dtype=jnp.float32)
    got = te.generate(cfg, fq, model["tsp"], prompt, max_new_tokens=2,
                      max_len=MAX_LEN, cache_mode="bf16",
                      compute_dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_bf16_baseline_matches_jax_op_by_op(model):
    """The bf16 comparator at 1 x 1024 (blockwise flash oracle on the CPU
    in both packages) and two decode steps, against JAX run op by op."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    toks = _tokens(1, S_LONG, seed=6)
    with jax.disable_jit():
        jc = je.init_cache(jcfg, 1, MAX_LEN)
        jl, jc = jb.bf16_prefill.__wrapped__(jcfg, model["jbp"],
                                             jnp.asarray(toks), jc, MAX_LEN)
        tc = te.init_cache(cfg, 1, MAX_LEN, device="cpu")
        tl, tc = tb.bf16_prefill(cfg, model["tbp"], toks, tc, MAX_LEN,
                                 device="cpu")
        steps = [(np.asarray(jl), tl.numpy())]
        for i in range(2):
            tok = steps[-1][0].argmax(-1)[:, None].astype(np.int32)
            jl, jc = jb.bf16_decode_step.__wrapped__(
                jcfg, model["jbp"], jnp.asarray(tok), jc, S_LONG + i,
                MAX_LEN)
            tl, tc = tb.bf16_decode_step(cfg, model["tbp"], tok, tc,
                                         S_LONG + i, MAX_LEN, device="cpu")
            steps.append((np.asarray(jl), tl.numpy()))
    for i, (jl, tl) in enumerate(steps):
        np.testing.assert_allclose(tl, jl, atol=0.07, rtol=0,
                                   err_msg=f"step {i}")
        np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))


def test_batcher_default_use_kernel_matches_jax(model):
    """ContinuousBatcher's use_kernel defaults to JAX's (False), so the
    same call takes the same route in both packages: a 300-token prompt
    prefilled through each batcher's default gives the same logits within
    1e-4. The port's old default (True) took the fused routes at 256+
    rows, which round at the kernels' points; the size of that difference
    on this prompt is printed (pytest -s)."""
    jdef = inspect.signature(JBatcher.__init__).parameters["use_kernel"]
    tdef = inspect.signature(ContinuousBatcher.__init__).parameters[
        "use_kernel"]
    assert jdef.default is tdef.default is False
    S = 300
    toks = np.random.default_rng(11).integers(
        0, model["cfg"].vocab_size, (1, S)).astype(np.int32)
    kw = dict(batch_slots=1, max_len=512, cache_mode="int4")
    jbat = JBatcher(model["jcfg"], model["jfq"], model["sp"],
                    compute_dtype=jnp.float32, **kw)
    want, _ = jbat._prefill_one(jbat.sp, jnp.asarray(toks),
                                jbat._new_cache1(),
                                jnp.asarray([S - 1], np.int32))
    logits = {}
    for uk in (False, True):
        extra = {} if uk is False else dict(use_kernel=True)
        tbat = ContinuousBatcher(model["cfg"], model["fq"], model["tsp"],
                                 compute_dtype=torch.float32, device="cpu",
                                 **kw, **extra)
        logits[uk] = tbat._prefill_one(toks[None, 0], tbat._new_cache1(),
                                       [S - 1]).numpy()
    np.testing.assert_allclose(logits[False], np.asarray(want), rtol=0,
                               atol=1e-4)
    moved = np.abs(logits[True] - np.asarray(want)).max()
    print(f"old default (use_kernel=True) moved the mini-128 prefill logits "
          f"by up to {moved:.3e} (scale {np.abs(want).max():.2f})")


def test_default_cache_mode_matches_jax(model):
    """init_cache and generate called with their defaults take the same
    cache mode (bf16) in both packages."""
    for fn in ("init_cache", "generate"):
        arg = "mode" if fn == "init_cache" else "cache_mode"
        jdef = inspect.signature(getattr(je, fn)).parameters[arg].default
        tdef = inspect.signature(getattr(te, fn)).parameters[arg].default
        assert jdef == tdef == "bf16", (fn, jdef, tdef)
    jc = je.init_cache(model["jcfg"], 2, 128)
    tc = te.init_cache(model["cfg"], 2, 128, device="cpu")
    assert set(jc) == set(tc) == {"k", "v"}
    for key in jc:
        assert len(tc[key]) == jc[key].shape[0]
        assert tuple(tc[key][0].shape) == jc[key].shape[1:]
        assert tc[key][0].dtype == torch.bfloat16 == getattr(
            torch, jc[key].dtype.name)
