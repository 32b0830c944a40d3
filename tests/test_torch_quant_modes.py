"""The balanced Kronecker split and the weight-only / int8-weight modes of
the port against the JAX package, on the CPU.

Kernels: inputs made with numpy from a seed go through JAX's Pallas
kernels (interpret mode, as the JAX package's own tests run them) and
through the port's wrappers, which on CPU tensors run their plain
versions: quant_acts_i8 (row 12), w4a4_matmul_i8_swiglu (row 13),
w4a8_matmul (row 14), and the decode and chunk attention at n_rep 5 and 7.
Engines: `mini-qwen` (Qwen-2.5's shape cut down: 7 query heads over one
kv head, qkv bias, hidden 896 -> balanced split (28, 32), intermediate
8448 -> (88, 96)) in JAX's default FlatQuant config (W4A4KV4 without
tpu_decompose), where JAX's engine takes rows 12 and 13 at 256 rows;
tiny-llama in W4A16, W8A8, W4A8 and W8A16; `mini-128` W4A16 with the
kernels; and layers without the o transform.

Tolerances, and why:
  - row 12: JAX's Pallas body divides by q_max as XLA on the CPU lowers
    it, which may be a multiplication by the reciprocal: scales within
    one float32 ulp, and codes equal but where such an ulp moves a value
    across a rounding tie;
  - row 13: the same float32 epilogue on exact integer sums: 2e-6, the
    JAX package's own bound for it (exp and sigmoid may differ by ulps);
  - row 14: integer codes are exact on both sides (bit-equal); bf16
    activations sum in float32 in another order: 1e-5 of the row's scale.
    In a W4A16 engine every linear casts its input to bf16 before the
    kernel, so float32 sums one ulp apart carry bf16 roundings through
    the layers (test_mini128_w4a16_kernel_route_matches_jax);
  - engines in float32: 1e-4 on logits of scale ~6-10 (lm_head sharpened
    6x). On mini-qwen at 256 rows the float32 Kronecker transforms sum in
    another order than XLA's, and at K = 896 and 8448 that puts an
    activation of a row next to a W4A4 rounding tie now and then: one
    code of the down input of layer 0 (row 12's input) and one of the
    qkv input of layer 1, which layer 1's attention spreads to the later
    rows. So the prefill runs each layer from JAX's input of that layer
    (`_layers_teacher_forced`, JAX op by op) and holds every layer to
    1e-4 but for the few rows such a tie moves (`_close_up_to_ties`);
    the decode steps then run whole, within 1e-4.
"""

import contextlib
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flatquant_tpu.core.kron import get_decompose_dim as j_decompose_dim
from flatquant_tpu.kernels import int4_matmul as jim
from flatquant_tpu.kernels import kv_cache as jkv
from flatquant_tpu.models.config import LlamaConfig as JLlamaConfig
from flatquant_tpu.models.config import get_config as j_get_config
from flatquant_tpu.models.llama import init_params as j_init_params
from flatquant_tpu.quantize.bake import bake_model
from flatquant_tpu.quantize.spec import FQConfig as JFQConfig
from flatquant_tpu.quantize.spec import W4A4KV4 as J_W4A4KV4
from flatquant_tpu.quantize.state import init_model_fq
from flatquant_tpu.serving import engine as je
from flatquant_tpu.serving import quantized as jq
from flatquant_tpu.serving.quantized import (
    build_serving_params as j_build_serving_params,
)
from flatquant_torch.core.kron import get_decompose_dim
from flatquant_torch.kernels import int4_matmul as tim
from flatquant_torch.kernels import kv_cache as tkv
from flatquant_torch.models.config import LlamaConfig, get_config, list_configs
from flatquant_torch.quantize.spec import FQConfig, W4A4KV4
from flatquant_torch.serving import engine as te
from flatquant_torch.serving import quantized as tq
from flatquant_torch.utils.convert import from_jax_serving_params

torch.set_num_threads(2)

MINI_QWEN = dict(name="mini-qwen", vocab_size=128, hidden_size=896,
                 intermediate_size=8448, num_layers=2, num_heads=7,
                 num_kv_heads=1, head_dim=128, rope_theta=1e6, rms_eps=1e-6,
                 attn_bias=True, seqlen=256)
MINI_128 = dict(name="mini-128", vocab_size=128, hidden_size=256,
                intermediate_size=512, num_layers=2, num_heads=2,
                num_kv_heads=2, head_dim=128, seqlen=256)


def _t(a):
    """numpy/JAX array -> torch CPU tensor (bf16 widened exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# ---------------------------------------------------------------------------
# the Kronecker split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rn128", [False, True])
def test_get_decompose_dim_matches_jax(rn128):
    # the widths JAX splits (quantize/state.py init_layer_fq): hidden and
    # intermediate of every registered model
    widths = set()
    for name in list_configs():
        cfg = get_config(name)
        widths |= {cfg.hidden_size, cfg.intermediate_size}
    for n in sorted(widths):
        assert get_decompose_dim(n, rn128) == j_decompose_dim(n, rn128), n
    # the balanced split's down transform: llama-2-7b keeps a 128 right
    # factor, Qwen-2.5-7B does not (rows 12 and 13 follow from that)
    assert get_decompose_dim(11008) == (86, 128)
    assert get_decompose_dim(18944) == (128, 148)


# ---------------------------------------------------------------------------
# rows 12-14: plain versions against JAX's Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,q_max,use_clip", [
    (300, 384, 7, False),    # m not a block multiple
    (256, 1408, 7, True),    # K = 11 * 128
    (128, 256, 127, False),  # the a8 grid
])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quant_acts_i8_matches_jax(rng, m, k, q_max, use_clip, dtype):
    x = rng.standard_normal((m, k)).astype(np.float32) * 3.0
    x[5] = 0.0  # zero row: scale 1, codes 0
    xj = jnp.asarray(x, dtype)
    clip = (0.83, 0.91) if use_clip else None
    jclip = None if clip is None else tuple(jnp.float32(c) for c in clip)
    tclip = None if clip is None else tuple(torch.tensor(c) for c in clip)
    wq, ws = jim.quant_acts_i8(xj, clip=jclip, q_max=q_max, interpret=True)
    for fn in (tim.quant_acts_i8_ref, tim.quant_acts_i8):
        gq, gs = fn(_t(xj), tclip, q_max)
        assert gq.dtype == torch.int8 and tuple(gs.shape) == (m, 1)
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=2e-7,
                                   atol=0, err_msg=fn.__name__)
        diff = gq.numpy().astype(np.int32) - np.asarray(wq, np.int32)
        same_scale = (gs.numpy() == np.asarray(ws))[:, 0]
        # where the scales are equal the codes are; elsewhere an ulp of
        # scale may move a value across a tie, by one code
        assert not diff[same_scale].any(), fn.__name__
        assert np.abs(diff).max() <= 1 and (diff != 0).mean() < 3e-3
        assert not gq[5].any() and gs[5].item() == 1.0


@pytest.mark.parametrize("m,k,nh", [(256, 256, 384), (300, 128, 256)])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_w4a4_matmul_i8_swiglu_matches_jax(rng, m, k, nh, out):
    w = rng.integers(-8, 8, (2 * nh, k)).astype(np.int8)
    wp = jim.pack_weight_planar(jnp.asarray(w))
    sw = rng.uniform(0.01, 0.1, (2 * nh,)).astype(np.float32)
    xq = rng.integers(-8, 8, (m, k)).astype(np.int8)
    xs = rng.uniform(0.1, 1.0, (m, 1)).astype(np.float32)
    want = jim.w4a4_matmul_i8_swiglu(jnp.asarray(xq), jnp.asarray(xs), wp,
                                     jnp.asarray(sw), out_dtype=jnp.dtype(out),
                                     interpret=True)
    args = (_t(xq), _t(xs), _t(wp), _t(sw), getattr(torch, out))
    for fn in (tim.w4a4_matmul_i8_swiglu_ref, tim.w4a4_matmul_i8_swiglu):
        got = fn(*args)
        assert tuple(got.shape) == (m, nh) and got.dtype == args[-1]
        if out == "float32":
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=2e-6, atol=2e-6,
                                       err_msg=fn.__name__)
        else:  # one bf16 ulp where the float32 values straddle a rounding
            w32 = np.asarray(want, np.float32)
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w32),
                                                      1e-30))) - 7)
            assert (np.abs(_np(got) - w32) <= ulp).all(), fn.__name__


@pytest.mark.parametrize("shape", [(8, 256, 384), (64, 512, 256),
                                   (17, 128, 128)])
@pytest.mark.parametrize("acts", ["codes", "bf16 activations"])
def test_w4a8_matmul_matches_jax(rng, shape, acts):
    m, k, n = shape
    q = rng.integers(-8, 8, (n, k)).astype(np.int8)
    wp = jim.pack_weight_planar(jnp.asarray(q))
    ws = rng.uniform(0.005, 0.02, (n,)).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32))
    if acts == "codes":
        xj, xs = jim.quantize_acts_sym(x)  # bf16 codes, f32 scales
    else:
        xj, xs = x.astype(jnp.bfloat16), jnp.ones((m, 1), jnp.float32)
    want = jim.w4a8_matmul(xj, xs, wp, jnp.asarray(ws), jnp.float32,
                           block_m=64, block_n=128, interpret=True)
    want_ref = jim.w4a8_matmul_ref(xj, xs, wp, jnp.asarray(ws), jnp.float32)
    args = (_t(xj), _t(xs), _t(wp), _t(ws), torch.float32)
    got = tim.w4a8_matmul(*args)
    got_ref = tim.w4a8_matmul_ref(*args)
    assert torch.equal(got, tim.w4a8_matmul_rowsum_ref(*args))
    if acts == "codes":  # integer sums: exact in every order
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got_ref.numpy(), np.asarray(want_ref))
    else:
        scale = np.abs(np.asarray(want)).max(axis=-1, keepdims=True)
        for g, w in ((got, want), (got_ref, want_ref)):
            assert (np.abs(g.numpy() - np.asarray(w)) <= 1e-5 * scale).all()


@pytest.mark.parametrize("nh,nkv", [(7, 1), (14, 2), (10, 2)])
@pytest.mark.parametrize("kernel", ["decode", "chunk"])
def test_attention_n_rep_5_and_7_matches_jax(rng, kernel, nh, nkv):
    """Qwen-2.5-7B's 7 query heads per kv head and Qwen-2.5-32B's 5."""
    B, S, hd = 3, 256, 128
    k = (rng.standard_normal((B, S, nkv, hd)) * 1.5).astype(np.float32)
    v = rng.standard_normal((B, S, nkv, hd)).astype(np.float32)
    kc, kpar = jkv.pack_kv_transposed(jnp.asarray(k))
    vc, vpar = jkv.pack_kv_transposed(jnp.asarray(v))
    kp, ks, kz = tkv.untranspose_kv(_t(kc), _t(kpar))
    vp, vs, vz = tkv.untranspose_kv(_t(vc), _t(vpar))
    kparam, vparam = torch.cat([ks, kz], -1), torch.cat([vs, vz], -1)
    sm = 1.0 / np.sqrt(hd)
    if kernel == "decode":
        q = rng.standard_normal((B, nh, hd)).astype(np.float32)
        valid = np.array([0, 77, 256], np.int32)
        want = jkv.decode_attention_int4_v4(
            jnp.asarray(q), kc, kpar, vc, vpar, jnp.asarray(valid), sm,
            interpret=True)
        got = tkv.decode_attention_int4(_t(q), kp, kparam, vp, vparam,
                                        _t(valid), sm)
    else:
        q = rng.standard_normal((B, 24, nh, hd)).astype(np.float32)
        pos = np.array([0, 100, S - 24], np.int32)
        want = jkv.chunk_attention_int4_v4(
            jnp.asarray(q), kc, kpar, vc, vpar, jnp.asarray(pos), sm,
            interpret=True)
        got = tkv.chunk_attention_int4(_t(q), kp, kparam, vp, vparam,
                                       _t(pos), sm)
    # float32: the JAX kernels fold scale/zero into their epilogues and sum
    # in another order than the plain dequant-then-softmax versions
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# mini-qwen, JAX's default (balanced) split: rows 12 and 13 on the path
# ---------------------------------------------------------------------------


def _baked(jcfg, jfq, seed=0, bias=False):
    params = j_init_params(jcfg, seed=seed)
    params["lm_head"] = params["lm_head"] * 6.0  # sharpen: no greedy ties
    if bias:  # Qwen's qkv bias, random (init_params zeroes it)
        rng = np.random.default_rng(seed)
        for key in ("bq", "bk", "bv"):
            shape = params["layers"][key].shape
            params["layers"][key] = jnp.asarray(
                rng.standard_normal(shape).astype(np.float32) * 0.02)
    return bake_model(jcfg, jfq, params, init_model_fq(jcfg, jfq, seed=seed))


def _serving(jcfg, jfq, baked):
    sp = j_build_serving_params(jcfg, jfq, *baked, dtype=jnp.float32,
                                merge_projections=True)
    return sp, from_jax_serving_params(jax.tree.map(np.asarray, sp),
                                       device="cpu")


@pytest.fixture(scope="module")
def qwen():
    jcfg = JLlamaConfig(**MINI_QWEN)
    sp, tsp = _serving(jcfg, J_W4A4KV4, _baked(jcfg, J_W4A4KV4, bias=True))
    return dict(jcfg=jcfg, jfq=J_W4A4KV4, sp=sp,
                cfg=LlamaConfig(**MINI_QWEN), fq=W4A4KV4, tsp=tsp)


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


@contextlib.contextmanager
def _layers_teacher_forced():
    """Record every call of JAX's serving_layer_int4cache (input and output
    x) and run the port's on JAX's input of the same call, recording its
    output, so each layer is compared from the same input."""
    rec = {"jax": [], "port": []}
    j_layer, t_layer = je.serving_layer_int4cache, te.serving_layer_int4cache

    def j_wrapped(*a, **kw):
        out = j_layer(*a, **kw)
        rec["jax"].append((np.asarray(a[3]), np.asarray(out[0])))
        return out

    def t_wrapped(*a, **kw):
        x_in = torch.from_numpy(rec["jax"][len(rec["port"])][0].copy())
        out = t_layer(*a[:3], x_in, *a[4:], **kw)
        rec["port"].append(out.numpy())
        return out

    je.serving_layer_int4cache = j_wrapped
    te.serving_layer_int4cache = t_wrapped
    try:
        yield rec
    finally:
        je.serving_layer_int4cache = j_layer
        te.serving_layer_int4cache = t_layer


def _close_up_to_ties(got, want, what):
    """float32 rows (last axis) within 1e-4, but for the rows where a W4A4
    code rounds apart at a float32 tie, and the later rows attention
    spreads it to: at most 10% of the rows beyond 1e-4, every row within
    5% of its norm (one code step of a 16-level quantizer moves its row by
    ~2%; a wrong mask, scale or layout moves every row by far more)."""
    got, want = np.asarray(got), np.asarray(want)
    d = np.abs(got - want).max(axis=-1)
    rel = (d / np.maximum(np.linalg.norm(want, axis=-1), 1e-30)).max()
    frac = (d > 1e-4).mean()
    assert frac <= 0.1 and rel <= 0.05, (what, frac, rel)


def test_mini_qwen_balanced_split_matches_jax_kernels_f32(qwen):
    """1 x 256 prefill (rows 12 and 13 in both engines, the attention
    prologue, the o path's left quant) and 8 decode steps over the int4
    cache, use_kernel=True on both sides."""
    jcfg, jfq, cfg, fq = qwen["jcfg"], qwen["jfq"], qwen["cfg"], qwen["fq"]
    S, MAX_LEN, L = 256, 384, cfg.num_layers
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, S)).astype(np.int32)
    kw = dict(max_len=MAX_LEN, use_kernel=True)
    fused = ["quant_acts_i8", "w4a4_matmul_i8_swiglu"]
    with _count(jq, fused) as jn, _count(tq, fused) as tn, \
            _count(te, ["attn_prologue", "left_quant_i8_flat"]) as tn_attn, \
            _count(tq, ["rmsnorm_right_flat",
                        "w4a4_matmul_i8_swiglu_right"]) as tn_rn128, \
            _layers_teacher_forced() as rec, jax.disable_jit():
        jc = je.init_cache(jcfg, 1, MAX_LEN, mode="int4")
        jl, jc = je.serving_prefill(jcfg, jfq, qwen["sp"], jnp.asarray(toks),
                                    jc, compute_dtype=jnp.float32, **kw)
        tc = te.init_cache(cfg, 1, MAX_LEN, mode="int4", device="cpu")
        tl, tc = te.serving_prefill(cfg, fq, qwen["tsp"], toks, tc,
                                    compute_dtype=torch.float32,
                                    device="cpu", **kw)
    # JAX's own engine takes rows 12 (the down input, K = 8448) and 13
    # (the MLP at 256 rows), once per layer, and so does the port
    assert jn == tn == {"quant_acts_i8": L, "w4a4_matmul_i8_swiglu": L}
    assert tn_attn == {"attn_prologue": L, "left_quant_i8_flat": L}
    assert tn_rn128 == {"rmsnorm_right_flat": 0,
                        "w4a4_matmul_i8_swiglu_right": 0}
    assert len(rec["port"]) == len(rec["jax"]) == L
    for i, ((_, want), got) in enumerate(zip(rec["jax"], rec["port"])):
        _close_up_to_ties(got, want, f"prefill layer {i}")
    steps = [(np.asarray(jl), tl.numpy())]
    for i in range(8):  # whole decode steps, teacher-forced with JAX's tokens
        tok = steps[-1][0].argmax(-1)[:, None].astype(np.int32)
        jl, jc = je.serving_decode_step(jcfg, jfq, qwen["sp"],
                                        jnp.asarray(tok), jc,
                                        jnp.int32(S + i),
                                        compute_dtype=jnp.float32, **kw)
        tl, tc = te.serving_decode_step(cfg, fq, qwen["tsp"], tok, tc, S + i,
                                        compute_dtype=torch.float32,
                                        device="cpu", **kw)
        steps.append((np.asarray(jl), tl.numpy()))
    for i, (jl, tl) in enumerate(steps):
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0,
                                   err_msg=f"step {i}")
        np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))


# ---------------------------------------------------------------------------
# weight-only and int8-weight serving
# ---------------------------------------------------------------------------


def _mode_cfgs(w_bits, a_bits):
    """JAX's test configs of these modes (tests/test_serving.py)."""
    kw = dict(w_bits=w_bits, a_bits=a_bits, k_bits=16, v_bits=16,
              lac=a_bits < 16, epochs=0)
    return JFQConfig(**kw), FQConfig(**kw)


def _run_both(jcfg, jfq, sp, cfg, fq, tsp, toks, n_decode, use_kernel,
              mode="bf16", max_len=64):
    """Prefill and n_decode greedy steps (teacher-forced with JAX's
    tokens) through both engines in float32. Returns per-step (jax, port)
    logits."""
    B, S = toks.shape
    kw = dict(max_len=max_len, use_kernel=use_kernel)
    jc = je.init_cache(jcfg, B, max_len, dtype=jnp.float32, mode=mode)
    tc = te.init_cache(cfg, B, max_len, dtype=torch.float32, mode=mode,
                       device="cpu")
    jl, jc = je.serving_prefill(jcfg, jfq, sp, jnp.asarray(toks), jc,
                                compute_dtype=jnp.float32, **kw)
    tl, tc = te.serving_prefill(cfg, fq, tsp, toks, tc,
                                compute_dtype=torch.float32, device="cpu",
                                **kw)
    steps = [(np.asarray(jl), tl.numpy())]
    for i in range(n_decode):
        tok = steps[-1][0].argmax(-1)[:, None].astype(np.int32)
        jl, jc = je.serving_decode_step(jcfg, jfq, sp, jnp.asarray(tok), jc,
                                        jnp.int32(S + i),
                                        compute_dtype=jnp.float32, **kw)
        tl, tc = te.serving_decode_step(cfg, fq, tsp, tok, tc, S + i,
                                        compute_dtype=torch.float32,
                                        device="cpu", **kw)
        steps.append((np.asarray(jl), tl.numpy()))
    return steps


def _check_steps(steps, atol=1e-4):
    for i, (jl, tl) in enumerate(steps):
        np.testing.assert_allclose(tl, jl, atol=atol, rtol=0,
                                   err_msg=f"step {i}")
        np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))


@pytest.mark.parametrize("w_bits,a_bits", [(4, 16), (8, 8), (4, 8), (8, 16)])
def test_quant_modes_match_jax_f32(w_bits, a_bits):
    """W4A16 (weight-only through w4a8_matmul's plain version), W8A8 and
    W4A8 (A8 codes, q_max 127; int8 x int8 -> int32 for "w8"), W8A16 (the
    int8 codes in a float matmul), over the bf16 cache in float32: a 2 x
    12 prefill and 3 decode steps, use_kernel=False as JAX's own tests of
    these modes run."""
    jfq, fq = _mode_cfgs(w_bits, a_bits)
    jcfg = j_get_config("tiny-llama")
    sp, tsp = _serving(jcfg, jfq, _baked(jcfg, jfq, seed=1))
    key = "w8" if w_bits == 8 else "wp"
    lin = tsp["layers"][0]["qkv"]
    assert key in lin and lin[key].dtype == (torch.int8 if w_bits == 8
                                             else torch.uint8)
    assert ("a_clip" in lin) == (a_bits < 16)
    assert "k_t" not in tsp["layers"][0]  # no k/q quant: no kcache transform
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    _check_steps(_run_both(jcfg, jfq, sp, get_config("tiny-llama"), fq, tsp,
                           toks, 3, use_kernel=False))


@pytest.mark.parametrize("w_bits", [4, 8])
def test_pack_linear_matches_jax(rng, w_bits):
    jfq, fq = _mode_cfgs(w_bits, 16)
    w = rng.standard_normal((96, 64)).astype(np.float32) * 0.02
    want = jq._pack_linear(jnp.asarray(w), jfq.w_cfg)
    got = tq._pack_linear(torch.from_numpy(w), fq.w_cfg)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], _t(want[key])), key
    assert got.get("w8", got.get("wp")).dtype == (
        torch.int8 if w_bits == 8 else torch.uint8)


def test_w8_params_convert_as_int8():
    jfq, _ = _mode_cfgs(8, 8)
    jcfg = j_get_config("tiny-llama")
    sp, tsp = _serving(jcfg, jfq, _baked(jcfg, jfq, seed=1))
    for i, layer in enumerate(tsp["layers"]):
        for nm in ("qkv", "o", "upgate", "down"):
            w8 = layer[nm]["w8"]
            assert w8.dtype == torch.int8, (i, nm)
            np.testing.assert_array_equal(
                w8.numpy(), np.asarray(sp["layers"][nm]["w8"][i]))


def test_mini128_w4a16_kernel_route_matches_jax():
    """W4A16 with use_kernel=True on both sides: every linear through
    w4a8_matmul on x cast to bf16 (JAX's interpret kernel; the port's
    plain version on CPU tensors), no fused route (activations are not
    quantized): a 2 x 64 prefill and 2 decode steps over the bf16 cache.

    The cast puts a bf16 rounding after every float32 sum, so a
    summation-order difference of one float32 ulp moves an input by a
    bf16 ulp now and then, and that carries through the layers: the cast
    alone moves JAX's logits (scale ~6-8) by 0.016-0.023 from its plain
    route; the port's kernel route reads 0.0024-0.0044 from JAX's (its
    plain route 4e-6). Held to 0.01, greedy tokens equal."""
    jfq, fq = _mode_cfgs(4, 16)
    jcfg, cfg = JLlamaConfig(**MINI_128), LlamaConfig(**MINI_128)
    sp, tsp = _serving(jcfg, jfq, _baked(jcfg, jfq))
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32)
    with _count(tq, ["w4a8_matmul", "w4a8_matmul_ref", "quant_acts_i8",
                     "rmsnorm_right_flat"]) as n:
        steps = _run_both(jcfg, jfq, sp, cfg, fq, tsp, toks, 2, True,
                          max_len=128)
    # 4 linears per layer, per prefill and per decode step
    assert n == {"w4a8_matmul": 4 * 2 * 3, "w4a8_matmul_ref": 0,
                 "quant_acts_i8": 0, "rmsnorm_right_flat": 0}
    _check_steps(steps, atol=0.01)


@pytest.mark.parametrize("mode", ["W4A4KV4, int4 cache", "W4A16, bf16 cache"])
def test_layers_without_o_t_match_jax_f32(mode):
    """Serving without the o head mixing: the attention output goes
    through the v transform's inverse per head (v_t_inv) into the o
    linear, in both cache engines."""
    jcfg, cfg = j_get_config("tiny-llama"), get_config("tiny-llama")
    if mode.startswith("W4A4KV4"):
        jfq, fq, cache = J_W4A4KV4, W4A4KV4, "int4"
    else:
        (jfq, fq), cache = _mode_cfgs(4, 16), "bf16"
    sp, _ = _serving(jcfg, jfq, _baked(jcfg, jfq, seed=2))
    sp["layers"] = {k: v for k, v in sp["layers"].items() if k != "o_t"}
    assert "v_t_inv" in sp["layers"]
    tsp = from_jax_serving_params(jax.tree.map(np.asarray, sp), device="cpu")
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    _check_steps(_run_both(jcfg, jfq, sp, cfg, fq, tsp, toks, 2,
                           use_kernel=False, mode=cache, max_len=128))
