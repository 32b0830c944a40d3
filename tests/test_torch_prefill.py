"""The port's fused prompt-prefill path against the JAX package, on the CPU.

Kernels: inputs made with numpy from a seed go through the JAX kernel (its
Pallas body in interpret mode, as the JAX package's own tests run it) and
through the port's wrapper, which on CPU tensors runs the plain PyTorch
version. Engine: a 2-layer `mini-128` model (head_dim 128, rn128 Kronecker
transforms) built in JAX with W4A4KV4 + tpu_decompose and served by both
engines with use_kernel=True; a 256-token prompt takes every fused route
(flat-pipeline attention input and MLP, attention prologue), a 2 x 128
prompt the fused input and MLP routes with composed attention.

Tolerances, and why:
  - integer parts (the int8 x int4 products) are exact on both sides;
  - float sums of the bf16 products (Kronecker right/left factors, the
    k_t / k_t_inv head products) run in another order in XLA's dot than
    in torch's matmul, so a bf16 output may round one ulp apart on a few
    elements in 10^4, and a code derived from it one step apart;
  - XLA on the CPU turns the kernels' divisions by the constants 7 and 15
    into a multiplication by the reciprocal (see the JAX package's own
    test_attn_prologue_matches_composed), so scales differ by one float32
    ulp and a code may move by one (two for asym KV, where the zero point
    moves too) on a few percent of rows at most;
  - engine logits: float32 agree to 1e-4; in bf16 a one-ulp q or k
    difference changes the unquantized attention, and the W4A4 re-rounding
    of every later projection grows it (random weights, lm_head sharpened
    6x), so the 256-token prompt is held to its caches and to a cosine of
    its logits, the 2 x 128 prompt (no prologue) to 0.07 as in
    tests/test_torch_serving.py.
"""

import contextlib
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flatquant_tpu.core.orth import random_orthogonal
from flatquant_tpu.kernels import flat_pipeline as jfp
from flatquant_tpu.kernels.attn_prologue import attn_prologue as j_prologue
from flatquant_tpu.kernels.int4_matmul import pack_weight_planar
from flatquant_tpu.kernels.kv_cache import untranspose_kv as j_untranspose
from flatquant_tpu.models.config import LlamaConfig as JLlamaConfig
from flatquant_tpu.models.llama import init_params as j_init_params
from flatquant_tpu.models.llama import rope_tables as j_rope_tables
from flatquant_tpu.quantize.bake import bake_model
from flatquant_tpu.quantize.spec import W4A4KV4 as J_W4A4KV4
from flatquant_tpu.quantize.state import init_model_fq
from flatquant_tpu.serving import engine as je
from flatquant_tpu.serving.quantized import (
    build_serving_params as j_build_serving_params,
)
from flatquant_torch.kernels import attn_prologue as tap
from flatquant_torch.kernels import flat_pipeline as tfp
from flatquant_torch.models.config import LlamaConfig
from flatquant_torch.quantize.spec import W4A4KV4
from flatquant_torch.serving import engine as te
from flatquant_torch.serving import quantized as tq
from flatquant_torch.utils.convert import from_jax_serving_params

torch.set_num_threads(2)

MINI = dict(name="mini-128", vocab_size=128, hidden_size=256,
            intermediate_size=512, num_layers=2, num_heads=2,
            num_kv_heads=2, head_dim=128, seqlen=256)
MAX_LEN = 384  # % 128 == 0: JAX's decode takes its kernel


def _t(a):
    """numpy/JAX array -> torch CPU tensor (bf16 widened exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _ulps(got, want):
    """Distance in units of the last place between two tensors of one
    float dtype (bf16 or f32), elementwise."""
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    ib = bits[got.dtype]
    sign = torch.iinfo(ib).min

    def key(t):
        i = t.contiguous().view(ib).to(torch.int64)
        return torch.where(i < 0, sign - i, i)

    return (key(got) - key(want)).abs()


def _check_ulps(got, want, max_ulps, max_frac, what):
    d = _ulps(got, _t(want).to(got.dtype))
    frac = (d > 0).double().mean().item()
    assert d.max().item() <= max_ulps and frac <= max_frac, (
        what, d.max().item(), frac)


def _nibble_diff(a, b):
    a = np.asarray(a).astype(np.int32)
    b = np.asarray(b).astype(np.int32)
    return np.abs(np.stack([a & 0xF, a >> 4]) - np.stack([b & 0xF, b >> 4]))


def _clips(clip):
    if clip is None:
        return None, None
    return (tuple(jnp.asarray(c) for c in clip),
            tuple(torch.tensor(c) for c in clip))


# ---------------------------------------------------------------------------
# kernels: plain versions against the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_right_flat_matches_jax(rng, dtype):
    x = jnp.asarray(rng.standard_normal((64, 256)) * 2.0, dtype)
    w = jnp.asarray(rng.uniform(0.5, 1.5, (256,)), jnp.float32)
    right = jnp.asarray(random_orthogonal(128, rng), jnp.float32)
    want = jfp.rmsnorm_right_flat(x, w, right, 1e-5, interpret=True)
    got = tfp.rmsnorm_right_flat(_t(x), _t(w), _t(right), 1e-5)
    assert got.dtype == torch.bfloat16 and got.shape == (64, 256)
    _check_ulps(got, want, 1, 1e-3, "rmsnorm_right_flat")


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("with_clip", [False, True])
def test_left_quant_i8_flat_matches_jax(rng, g, with_clip):
    x = jnp.asarray(rng.standard_normal((64, g * 128)) * 3.0, jnp.bfloat16)
    x = x.at[5].set(0.0)  # an all-zero row: scale 1, codes 0
    left_t = jnp.asarray(random_orthogonal(g, rng), jnp.bfloat16)
    jclip, tclip = _clips((np.float32(0.9), np.float32(0.95))
                          if with_clip else None)
    wq, ws = jfp.left_quant_i8_flat(left_t, x, clip=jclip, interpret=True)
    gq, gs = tfp.left_quant_i8_flat(_t(left_t), _t(x), tclip)
    assert gq.dtype == torch.int8 and gs.shape == (64, 1)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6)
    d = np.abs(gq.numpy().astype(np.int32) - np.asarray(wq, np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())
    assert gs[5].item() == 1.0 and not gq[5].any()


def test_left_quant_i8_flat_o_path_matches_jax(rng):
    """The attention output's head mixing: left_t = o_t.T, the input
    rounded to bf16 from a float32 attention output."""
    g = 4
    attn = rng.standard_normal((64, g * 128)).astype(np.float32)
    o_t = jnp.asarray(random_orthogonal(g, rng), jnp.float32)
    xb = jnp.asarray(attn).astype(jnp.bfloat16)
    wq, ws = jfp.left_quant_i8_flat(o_t.T, xb, q_max=7, interpret=True)
    gq, gs = tfp.left_quant_i8_flat(_t(o_t).T, _t(attn).to(torch.bfloat16))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6)
    d = np.abs(gq.numpy().astype(np.int32) - np.asarray(wq, np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("right_dtype", ["float32", "bfloat16"])
def test_w4a4_matmul_i8_swiglu_right_matches_jax(rng, right_dtype):
    m, k, nh = 64, 256, 256
    w = jnp.asarray(rng.integers(-8, 8, (2 * nh, k)), jnp.int8)
    wp = pack_weight_planar(w)
    sw = jnp.asarray(rng.uniform(0.01, 0.05, (2 * nh,)), jnp.float32)
    xq = jnp.asarray(rng.integers(-8, 8, (m, k)), jnp.int8)
    xs = jnp.asarray(rng.uniform(0.1, 1.0, (m, 1)), jnp.float32)
    right = jnp.asarray(random_orthogonal(128, rng), right_dtype)
    want = jfp.w4a4_matmul_i8_swiglu_right(xq, xs, wp, sw, right,
                                           interpret=True)
    got = tfp.w4a4_matmul_i8_swiglu_right(_t(xq), _t(xs), _t(wp), _t(sw),
                                          _t(right))
    assert got.dtype == torch.bfloat16 and got.shape == (m, nh)
    _check_ulps(got, want, 1, 1e-3, "w4a4_matmul_i8_swiglu_right")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_prologue_matches_jax(rng, dtype):
    B, S, nh, nkv, hd = 2, 128, 3, 2, 128  # GQA
    jcfg = JLlamaConfig(name="t", hidden_size=nh * hd, num_heads=nh,
                        num_kv_heads=nkv, head_dim=hd)
    qkv = jnp.asarray(rng.standard_normal((B, S, (nh + 2 * nkv) * hd)) * 2,
                      dtype)
    cos, sin = j_rope_tables(jcfg, jnp.arange(S))
    k_t = jnp.asarray(random_orthogonal(hd, rng), dtype)
    k_t_inv = jnp.asarray(random_orthogonal(hd, rng), dtype)
    kclip, tkclip = _clips((np.float32(0.92), np.float32(0.9)))
    vclip, tvclip = _clips((np.float32(0.95), np.float32(0.97)))
    want = j_prologue(qkv, cos, sin, k_t, k_t_inv, kclip, vclip, nh=nh,
                      nkv=nkv, interpret=True)
    got = tap.attn_prologue(_t(qkv), _t(cos), _t(sin), _t(k_t),
                            _t(k_t_inv), tkclip, tvclip, nh=nh, nkv=nkv)
    q, k, v, kp, kpar, vp, vpar = got
    assert q.dtype == k.dtype == getattr(torch, dtype)
    k_tm = np.asarray(want[1], np.float32).transpose(0, 3, 1, 2)
    k_tm = k_tm.reshape(B, S, nkv * hd)
    if dtype == "bfloat16":
        # one ulp on a few elements in 10^4 (head-product sum order)
        _check_ulps(q, want[0], 1, 1e-3, "q_rot")
        _check_ulps(k, k_tm, 1, 1e-3, "k_rot")
    else:  # float32 sums of 128 products of size ~1 in another order
        np.testing.assert_allclose(q.numpy(), np.asarray(want[0]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(k.numpy(), k_tm, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(v.float().numpy(),
                                  np.asarray(want[2], np.float32))
    for name, codes, params, jc, jp in (("k", kp, kpar, want[3], want[4]),
                                        ("v", vp, vpar, want[5], want[6])):
        pk, sc, zr = j_untranspose(jc, jp)
        d = _nibble_diff(codes.numpy(), pk)
        # one f32 ulp of the scale moves the zero point and the code
        assert d.max() <= 2 and (d > 0).mean() < 0.03, (name, d.max())
        np.testing.assert_allclose(params[..., 0].numpy(),
                                   np.asarray(sc)[..., 0], rtol=1e-6)
        assert np.abs(params[..., 1].numpy()
                      - np.asarray(zr)[..., 0]).max() <= 1, name


def test_attn_prologue_writes_cache_in_place(rng):
    B, S, L, pos, nh, nkv = 1, 64, 256, 100, 2, 1
    qkv = torch.from_numpy(
        rng.standard_normal((B, S, (nh + 2 * nkv) * 128)).astype(np.float32))
    cos = torch.from_numpy(rng.standard_normal((S, 128)).astype(np.float32))
    sin = torch.from_numpy(rng.standard_normal((S, 128)).astype(np.float32))
    k_t = torch.from_numpy(random_orthogonal(128, rng).astype(np.float32))
    fresh = tap.attn_prologue(qkv, cos, sin, k_t, k_t.T, nh=nh, nkv=nkv)
    cache = [torch.full((B, nkv, L, 64), 7, dtype=torch.uint8),
             torch.full((B, nkv, L, 2), -3.0),
             torch.full((B, nkv, L, 64), 9, dtype=torch.uint8),
             torch.full((B, nkv, L, 2), -5.0)]
    before = [c.clone() for c in cache]
    out = tap.attn_prologue(qkv, cos, sin, k_t, k_t.T, nh=nh, nkv=nkv,
                            cache=cache, pos=pos)
    assert all(a is b for a, b in zip(out[3:], cache))
    for c, b, f in zip(cache, before, fresh[3:]):
        assert torch.equal(c[:, :, pos:pos + S], f)
        assert torch.equal(c[:, :, :pos], b[:, :, :pos])
        assert torch.equal(c[:, :, pos + S:], b[:, :, pos + S:])


# ---------------------------------------------------------------------------
# engine: the fused prefill against JAX's use_kernel=True engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    jcfg = JLlamaConfig(**MINI)
    jfq = dataclasses.replace(J_W4A4KV4, tpu_decompose=True)
    params = j_init_params(jcfg, seed=0)
    params["lm_head"] = params["lm_head"] * 6.0  # sharpen: no greedy ties
    bp, bfq = bake_model(jcfg, jfq, params, init_model_fq(jcfg, jfq, seed=0))
    sp = {dt: j_build_serving_params(jcfg, jfq, bp, bfq, dtype=jnp.dtype(dt),
                                     merge_projections=True)
          for dt in ("float32", "bfloat16")}
    return dict(jcfg=jcfg, jfq=jfq, sp=sp, cfg=LlamaConfig(**MINI),
                fq=dataclasses.replace(W4A4KV4, tpu_decompose=True),
                tsp={dt: from_jax_serving_params(
                    jax.tree.map(np.asarray, sp[dt]), device="cpu")
                     for dt in sp})


@contextlib.contextmanager
def _count_routes():
    """Count calls of the port's fused-route kernel wrappers."""
    n = {}
    targets = [(tq, "rmsnorm_right_flat"), (tq, "left_quant_i8_flat"),
               (tq, "w4a4_matmul_i8_swiglu_right"), (te, "attn_prologue"),
               (te, "left_quant_i8_flat")]
    saved = [(m, name, getattr(m, name)) for m, name in targets]

    def counting(key, fn):
        def wrapped(*a, **kw):
            n[key] = n.get(key, 0) + 1
            return fn(*a, **kw)
        return wrapped

    for m, name, fn in saved:
        key = "o " + name if m is te and name == "left_quant_i8_flat" else name
        setattr(m, name, counting(key, fn))
    try:
        yield n
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def _run_both(model, dt, B, S, n_decode):
    jcfg, jfq, cfg, fq = model["jcfg"], model["jfq"], model["cfg"], model["fq"]
    sp, tsp = model["sp"][dt], model["tsp"][dt]
    jdt, tdt = jnp.dtype(dt), getattr(torch, dt)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    kw = dict(max_len=MAX_LEN)
    jc = je.init_cache(jcfg, B, MAX_LEN, mode="int4")
    jl, jc = je.serving_prefill(jcfg, jfq, sp, jnp.asarray(toks), jc,
                                use_kernel=True, compute_dtype=jdt, **kw)
    tc = te.init_cache(cfg, B, MAX_LEN, mode="int4", device="cpu")
    with _count_routes() as routes:
        tl, tc = te.serving_prefill(cfg, fq, tsp, toks, tc, compute_dtype=tdt,
                                    device="cpu", **kw)
    steps = [(np.asarray(jl), tl.numpy())]
    for i in range(n_decode):  # teacher-forced with JAX's greedy tokens
        tok = steps[-1][0].argmax(-1)[:, None].astype(np.int32)
        jl, jc = je.serving_decode_step(jcfg, jfq, sp, jnp.asarray(tok), jc,
                                        jnp.int32(S + i), use_kernel=True,
                                        compute_dtype=jdt, **kw)
        tl, tc = te.serving_decode_step(cfg, fq, tsp, tok, tc, S + i,
                                        compute_dtype=tdt, device="cpu", **kw)
        steps.append((np.asarray(jl), tl.numpy()))
    return steps, jc, tc, routes


def _check_caches(model, jc, tc, scale_frac=0.0):
    """Nibbles within 1 on < 1%; scales within rtol 1e-5 on all but
    scale_frac of the (token, head) rows."""
    for key, pkey in (("kp", "kparam"), ("vp", "vparam")):
        for i in range(model["cfg"].num_layers):
            pk, sc, zr = j_untranspose(jc[key][i], jc[pkey][i])
            d = _nibble_diff(pk, tc[key][i].numpy())
            assert d.max() <= 1 and (d > 0).mean() < 0.01, (key, i, d.max())
            want = np.asarray(sc)[..., 0]
            off = ~np.isclose(tc[pkey][i][..., 0].numpy(), want, rtol=1e-5,
                              atol=0)
            assert off.mean() <= scale_frac, (key, i, off.mean())


# per prefill of the 2-layer model: ln1 and ln2 each take rmsnorm_right_flat
# and left_quant_i8_flat; the MLP's down input one more left_quant; the
# prologue route adds attn_prologue and the o-path left_quant
ROUTES = {
    (1, 256): {"rmsnorm_right_flat": 4, "left_quant_i8_flat": 6,
               "w4a4_matmul_i8_swiglu_right": 2, "attn_prologue": 2,
               "o left_quant_i8_flat": 2},
    (2, 128): {"rmsnorm_right_flat": 4, "left_quant_i8_flat": 6,
               "w4a4_matmul_i8_swiglu_right": 2},
}


@pytest.mark.parametrize("B,S,n_decode", [(1, 256, 2), (2, 128, 0)])
def test_fused_prefill_matches_jax_f32(model, B, S, n_decode):
    steps, jc, tc, routes = _run_both(model, "float32", B, S, n_decode)
    assert routes == ROUTES[(B, S)]
    for i, (jl, tl) in enumerate(steps):
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0,
                                   err_msg=f"step {i}")
        np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
    _check_caches(model, jc, tc)


@pytest.mark.parametrize("B,S,n_decode", [(1, 256, 2), (2, 128, 0)])
def test_fused_prefill_bf16_matches_jax_op_by_op(model, B, S, n_decode):
    """bf16 against JAX with jit disabled: jitted XLA on the CPU drops
    intermediate bf16 roundings (ROADMAP section 3), the port rounds op by
    op as the JAX code is written."""
    with jax.disable_jit():
        steps, jc, tc, routes = _run_both(model, "bfloat16", B, S, n_decode)
    assert routes == ROUTES[(B, S)]
    prologue = S % 128 == 0 and S >= 256
    # the prologue route: layer 1's inputs already carry the grown
    # rounding differences of layer 0, which move a few scales
    _check_caches(model, jc, tc, scale_frac=0.02 if prologue else 0.0)
    for i, (jl, tl) in enumerate(steps):
        if prologue:
            cos = (tl * jl).sum(-1) / np.linalg.norm(tl, axis=-1) \
                / np.linalg.norm(jl, axis=-1)
            assert cos.min() > 0.99, (i, cos)
            np.testing.assert_allclose(tl, jl, atol=0.75, rtol=0,
                                       err_msg=f"step {i}")
        else:  # one bf16 ulp of a logit of size ~6 is 0.03
            np.testing.assert_allclose(tl, jl, atol=0.07, rtol=0,
                                       err_msg=f"step {i}")
            np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
