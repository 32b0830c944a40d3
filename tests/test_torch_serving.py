"""The port's decode-serving path against the JAX package, on the CPU.

A 2-layer `mini-128` model (head_dim 128, rn128 Kronecker transforms) is
built in JAX with W4A4KV4 + tpu_decompose, baked and packed with
build_serving_params(merge_projections=True). The port packs the same
baked weights and baked FQ state (converted with from_jax_params /
from_jax_fq; byte-equal check, in the merged layout and JAX's default
unmerged one) and serves the same packed params (converted with
from_jax_serving_params); prefill, scalar-position decode and per-slot
decode must give the JAX engine's logits and greedy tokens, and the
packed caches must agree.

Tolerances:
  - float32 params and compute on both sides: the integer parts are
    exact, the float parts differ only in summation order, so logits
    agree to 1e-4 on a logit scale of ~6.6 (measured max 4e-6)
  - bfloat16: JAX's jitted engine is no fixed target -- XLA on the CPU
    drops intermediate bf16 roundings inside its fusions, and jit vs
    op-by-op JAX differ by up to 0.86 on the same logits. The port runs
    op by op, so the bf16 case holds it against JAX with jit disabled;
    the only differences left are bf16 matmul summation-order ties.
"""

import ast
import dataclasses
import inspect
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flatquant_tpu.kernels.kv_cache import untranspose_kv as j_untranspose
from flatquant_tpu.models.config import LlamaConfig as JLlamaConfig
from flatquant_tpu.models.llama import init_params as j_init_params
from flatquant_tpu.quantize.bake import bake_model
from flatquant_tpu.quantize.spec import W4A4KV4 as J_W4A4KV4
from flatquant_tpu.quantize.state import init_model_fq
from flatquant_tpu.serving import engine as je
from flatquant_tpu.serving.quantized import (
    build_serving_params as j_build_serving_params,
)
from flatquant_torch.models.config import LlamaConfig
from flatquant_torch.quantize.spec import W4A4KV4
from flatquant_torch.serving import engine as te
from flatquant_torch.serving.quantized import (
    build_serving_layer,
    build_serving_params,
)
from flatquant_torch.utils.convert import (
    from_jax_fq,
    from_jax_params,
    from_jax_serving_params,
)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
B, S, MAX_LEN = 2, 32, 128  # MAX_LEN % 128 == 0: JAX takes write_token_v4
MINI = dict(name="mini-128", vocab_size=128, hidden_size=256,
            intermediate_size=512, num_layers=2, num_heads=2,
            num_kv_heads=2, head_dim=128, seqlen=256)


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
    return dict(jcfg=jcfg, jfq=jfq, bp=bp, bfq=bfq, sp=sp,
                cfg=LlamaConfig(**MINI),
                fq=dataclasses.replace(W4A4KV4, tpu_decompose=True),
                tsp={dt: from_jax_serving_params(
                    jax.tree.map(np.asarray, sp[dt]), device="cpu")
                     for dt in sp})


def _check_packed_equal(got, want, tdt, names):
    for i in range(len(want["layers"])):
        g, w = got["layers"][i], want["layers"][i]
        assert set(g) == set(w), (set(g) ^ set(w))
        for nm in names:
            assert torch.equal(g[nm]["wp"], w[nm]["wp"]), (i, nm)
            assert torch.equal(g[nm]["scale"], w[nm]["scale"]), (i, nm)
            for a, b in zip(g[nm]["a_clip"], w[nm]["a_clip"]):
                assert torch.equal(a, b), (i, nm)
        for key in ("ln_t", "ug_t", "down_t"):
            for a, b in zip(g[key], w[key]):
                assert a.dtype == tdt and torch.equal(a, b), (i, key)
        for key in ("o_t", "k_t", "k_t_inv", "v_t_inv", "ln1_w", "ln2_w"):
            assert torch.equal(g[key], w[key]), (i, key)
        for key in ("kc_clip", "vc_clip"):
            for a, b in zip(g[key], w[key]):
                assert torch.equal(a, b), (i, key)
    for key in ("embed", "final_norm_w", "lm_head"):
        assert torch.equal(got[key], want[key]), key


def _port_build(model, **kw):
    """The port's build_serving_params on JAX's baked params and baked FQ
    state, both converted."""
    return build_serving_params(
        model["cfg"], model["fq"],
        from_jax_params(jax.tree.map(np.asarray, model["bp"]), "cpu"),
        from_jax_fq(jax.tree.map(np.asarray, model["bfq"]), "cpu"), **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_serving_params_byte_equal(model, dtype):
    tdt = getattr(torch, dtype)
    got = _port_build(model, dtype=tdt, merge_projections=True)
    want = from_jax_serving_params(
        jax.tree.map(np.asarray, model["sp"][dtype]), device="cpu")
    _check_packed_equal(got, want, tdt, ("qkv", "o", "upgate", "down"))


def _nibbles(a):
    a = np.asarray(a).astype(np.int32)
    return np.stack([a & 0xF, a >> 4])


def _run_both(model, jdt, use_kernel_jax, n_scalar, n_slot, max_len=MAX_LEN):
    """Prefill, n_scalar scalar-pos decode steps, n_slot per-slot decode
    steps with ragged positions, teacher-forced with JAX's greedy tokens.
    Returns per-step (jax logits, port logits) and both caches."""
    jcfg, jfq, cfg, fq = model["jcfg"], model["jfq"], model["cfg"], model["fq"]
    sp, tsp = model["sp"][jdt], model["tsp"][jdt]
    jdt, tdt = jnp.dtype(jdt), getattr(torch, jdt)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    jc = je.init_cache(jcfg, B, max_len, mode="int4")
    tc = te.init_cache(cfg, B, max_len, mode="int4", device="cpu")
    kw = dict(max_len=max_len)
    jl, jc = je.serving_prefill(jcfg, jfq, sp, jnp.asarray(toks), jc,
                                use_kernel=use_kernel_jax,
                                compute_dtype=jdt, **kw)
    tl, tc = te.serving_prefill(cfg, fq, tsp, toks, tc, compute_dtype=tdt,
                                device="cpu", **kw)
    steps = [(np.asarray(jl), tl.numpy())]
    positions = [S + i for i in range(n_scalar)]
    ragged = np.array([S + n_scalar, S + n_scalar - 3], np.int32)
    positions += [ragged + i for i in range(n_slot)]
    for pos in positions:
        tok = steps[-1][0].argmax(-1)[:, None].astype(np.int32)
        jpos = jnp.asarray(pos, jnp.int32)
        tpos = torch.as_tensor(pos) if isinstance(pos, np.ndarray) else pos
        jl, jc = je.serving_decode_step(jcfg, jfq, sp, jnp.asarray(tok), jc,
                                        jpos, use_kernel=use_kernel_jax,
                                        compute_dtype=jdt, **kw)
        tl, tc = te.serving_decode_step(cfg, fq, tsp, tok, tc, tpos,
                                        compute_dtype=tdt, device="cpu",
                                        **kw)
        steps.append((np.asarray(jl), tl.numpy()))
    return steps, jc, tc


def _check_caches(model, jc, tc):
    for key, pkey in (("kp", "kparam"), ("vp", "vparam")):
        for i in range(model["cfg"].num_layers):
            pk, sc, zr = j_untranspose(jc[key][i], jc[pkey][i])
            d = np.abs(_nibbles(pk) - _nibbles(tc[key][i].numpy()))
            assert d.max() <= 1 and (d > 0).mean() < 0.01, (key, i, d.max())
            np.testing.assert_allclose(tc[pkey][i][..., 0].numpy(),
                                       np.asarray(sc)[..., 0], rtol=1e-5)


def test_engine_matches_jax_kernels_f32(model):
    """The port against JAX's use_kernel=True engine (its Pallas kernels in
    interpret mode): w4a4_matmul_i8 on every linear,
    decode_attention_int4_v4 and write_token_v4."""
    steps, jc, tc = _run_both(model, "float32", True,
                              n_scalar=8, n_slot=4)
    for i, (jl, tl) in enumerate(steps):
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0,
                                   err_msg=f"step {i}")
        np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
    _check_caches(model, jc, tc)


def test_engine_bf16_matches_jax_op_by_op(model):
    with jax.disable_jit():
        steps, jc, tc = _run_both(model, "bfloat16", False, n_scalar=1, n_slot=1,
                                  max_len=96)
    for i, (jl, tl) in enumerate(steps):
        # one bf16 ulp of a logit of size ~6.6 is 0.03
        np.testing.assert_allclose(tl, jl, atol=0.07, rtol=0,
                                   err_msg=f"step {i}")
        np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
    _check_caches(model, jc, tc)


def test_generate_matches_jax(model):
    jcfg, jfq, cfg, fq = model["jcfg"], model["jfq"], model["cfg"], model["fq"]
    prompt = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    want = je.generate(jcfg, jfq, model["sp"]["float32"], prompt,
                       max_new_tokens=6, max_len=MAX_LEN, use_kernel=True,
                       cache_mode="int4", compute_dtype=jnp.float32)
    got = te.generate(cfg, fq, model["tsp"]["float32"], prompt,
                      max_new_tokens=6, max_len=MAX_LEN, cache_mode="int4",
                      compute_dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_from_jax_bf16_is_exact(model):
    sp = model["sp"]["bfloat16"]
    tsp = model["tsp"]["bfloat16"]
    assert tsp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tsp["embed"].float().numpy(),
                                  np.asarray(sp["embed"], np.float32))
    left = np.asarray(sp["layers"]["ln_t"][0][1], np.float32)
    np.testing.assert_array_equal(
        tsp["layers"][1]["ln_t"][0].float().numpy(), left)


def test_init_params_seeded_and_shaped_like_jax(model):
    from flatquant_torch.models.llama import init_params

    cfg = model["cfg"]
    a = init_params(cfg, seed=3, device="cpu")
    b = init_params(cfg, seed=3, device="cpu")
    c = init_params(cfg, seed=4, device="cpu")
    jp = j_init_params(model["jcfg"], seed=3)
    assert len(a["layers"]) == cfg.num_layers
    for k, v in jp["layers"].items():
        assert tuple(a["layers"][0][k].shape) == v.shape[1:], k
        assert torch.equal(a["layers"][1][k], b["layers"][1][k]), k
    for k in ("embed", "final_norm_w", "lm_head"):
        assert tuple(a[k].shape) == jp[k].shape, k
    assert not torch.equal(a["embed"], c["embed"])
    assert abs(a["layers"][0]["wq"].std().item() - 0.02) < 2e-3


def test_sample_token_greedy_and_seeded():
    logits = torch.tensor([[0.1, 2.0, -1.0], [3.0, 0.0, 1.0]])
    greedy = te.sample_token(logits)
    assert greedy.dtype == torch.int32 and greedy.tolist() == [[1], [0]]
    draw = lambda seed: te.sample_token(
        logits, 0.7, torch.Generator().manual_seed(seed))
    assert torch.equal(draw(1), draw(1)) and draw(1).shape == (2, 1)


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------


def _port_files():
    return sorted((REPO / "flatquant_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


def _tokenizer_branch(node, parents) -> bool:
    """node lies under an `if` whose test reads tokenizer_path."""
    while node in parents:
        node = parents[node]
        if isinstance(node, ast.If) and "tokenizer_path" in ast.dump(
                node.test):
            return True
    return False


def test_port_imports_neither_jax_nor_the_jax_package():
    """No port file imports JAX, the JAX package, or a package the card's
    machine lacks (msgpack, flax, optax, safetensors); transformers only
    inside the CLI's --tokenizer_path branch, where JAX's main.py imports
    it."""
    files = _port_files()
    assert len(files) > 10 and files[-1].exists()
    names = {str(p.relative_to(REPO)) for p in files}
    for module in ("core/ste.py", "core/packing.py", "core/orth.py",
                   "core/quant.py", "core/kron.py", "core/transforms.py",
                   "quantize/linear.py", "quantize/state.py",
                   "quantize/bake.py", "models/llama.py",
                   "utils/convert.py", "calib/data.py", "calib/trainer.py",
                   "calib/gptq.py", "evals/ppl.py", "utils/checkpoint.py",
                   "utils/logging_utils.py", "utils/reference_convert.py",
                   "models/loader.py", "main.py"):
        assert "flatquant_torch/" + module in names, module
    banned = ("jax", "jaxlib", "flatquant_tpu", "msgpack", "flax", "optax",
              "safetensors")
    tokenizer_imports = 0
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        parents = {child: node for node in ast.walk(tree)
                   for child in ast.iter_child_nodes(node)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in banned, (path, name)
                if top == "transformers":
                    assert _tokenizer_branch(node, parents), (path, name)
                    tokenizer_imports += 1
    assert tokenizer_imports == 1


@pytest.mark.parametrize("fn", [build_serving_params,
                                build_serving_layer])
@pytest.mark.parametrize("arg", ["merge_projections", "tp",
                                 "perm_transforms"])
def test_build_serving_defaults_match_jax(fn, arg):
    """The port's packers take JAX's build_serving_params defaults (the
    merged layout was the port's default until the fault was fixed)."""
    want = inspect.signature(j_build_serving_params).parameters[arg].default
    assert inspect.signature(fn).parameters[arg].default == want


def test_build_serving_params_default_unmerged_matches_jax(model):
    """With every default (JAX's unmerged layout: q, k, v, up, gate each
    packed alone, with its own activation clips) the port packs what JAX
    packs, byte for byte. (The port raised on this default, naming
    ROADMAP item 4, until the build chain was ported.)"""
    jsp = j_build_serving_params(model["jcfg"], model["jfq"], model["bp"],
                                 model["bfq"])
    want = from_jax_serving_params(jax.tree.map(np.asarray, jsp), "cpu")
    got = _port_build(model)
    assert "qkv" not in got["layers"][0] and "q" in got["layers"][0]
    _check_packed_equal(got, want, torch.bfloat16,
                        ("q", "k", "v", "o", "up", "gate", "down"))


def test_default_device_raises_without_a_card(model):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    cfg, fq = model["cfg"], model["fq"]
    with pytest.raises(RuntimeError, match="cuda"):
        te.init_cache(cfg, 1, MAX_LEN)
    cache = te.init_cache(cfg, 1, MAX_LEN, mode="int4", device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        te.serving_prefill(cfg, fq, model["tsp"]["float32"],
                           np.zeros((1, 4), np.int32), cache)
    with pytest.raises(RuntimeError, match="cuda"):
        from_jax_serving_params(
            jax.tree.map(np.asarray, model["sp"]["float32"]))


def test_unported_routes_raise(model):
    """Branches the port does not have yet raise, naming their ROADMAP
    item, instead of taking another route: tp and ring attention (item
    9). Unmerged projections and the perm layouts serve
    (tests/test_torch_build_chain.py). Weight-only
    serving, serving without the o transform, the quant_acts_i8 route (T
    >= 256, K >= 8192) and the fused swiglu GEMM (T >= 256) run
    (tests/test_torch_quant_modes.py), as do the paged cache and the chunk
    phase (tests/test_torch_batcher.py)."""
    from flatquant_torch.kernels.int4_matmul import (
        quant_acts_i8_ref, w4a4_matmul_i8_swiglu_ref)
    from flatquant_torch.serving import quantized as tq

    cfg, fq = model["cfg"], model["fq"]
    cache = te.init_cache(cfg, 1, MAX_LEN, mode="int4", device="cpu")
    layer_cache = [cache[k][0] for k in ("kp", "kparam", "vp", "vparam")]
    sl = model["tsp"]["float32"]["layers"][0]
    x = torch.zeros((1, 4, cfg.hidden_size))

    def chunk_layer(sl=sl, fq=fq, **kw):
        te.serving_layer_int4cache(cfg, fq, sl, x, None, None, *layer_cache,
                                   0, "chunk", False, torch.float32, **kw)

    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 9"):
        chunk_layer(tp_axis="tp")
    bf16 = te.init_cache(cfg, 1, MAX_LEN, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 9"):
        te.serving_layer(cfg, fq, sl, x, None, None, bf16["k"][0],
                         bf16["v"][0], 0, "chunk", False, torch.float32,
                         attn_fn=lambda *a: None)
    assert not any(bool(t.any()) for t in layer_cache)  # nothing written

    # the routes that raised before this slice: rows 12 and 13 run (their
    # plain versions, on CPU tensors)
    g = torch.Generator().manual_seed(0)
    lin = {"wp": torch.randint(0, 256, (256, 4096), dtype=torch.uint8,
                               generator=g),
           "scale": torch.rand(256, generator=g) * 0.01}
    xl = torch.randn((256, 8192), generator=g)
    y = tq._quant_linear(xl, lin, use_kernel=True)
    assert torch.equal(y, tq._quant_linear(xl, lin, use_kernel=False))
    act = tq._quant_swiglu(xl, lin, use_kernel=True)
    xq, xs = quant_acts_i8_ref(xl, None, 7)
    assert torch.equal(act, w4a4_matmul_i8_swiglu_ref(xq, xs, lin["wp"],
                                                      lin["scale"]))
