"""Pipeline parallelism in the port (flatquant_torch/parallel/pipeline.py,
the batcher's pp_mesh) against the port's sequential engine and JAX's
(tests/test_pipeline.py, tests/test_batcher_pp.py).

The port runs four gloo ranks on the CPU in one spawn
(tests/_torch_par_cases.py pp_cases), as pp = 4 and as dp 2 x pp 2. Each
stage runs only its own microbatches (no bubble tick computes or writes),
so the pipelined outputs must equal the sequential engine's bit for bit:
the real-quant serving forward over the bf16, int4 and paged caches
(prefill + 2 decode steps), llama_forward in fp and eval modes and under
dp, and the continuous batcher's greedy tokens in every cache mode and
with chunked prefill. JAX's sequential results on the same models are the
cross-package reference (float32, JAX's 1e-5; tokens equal).
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import _torch_par_cases as cases
from flatquant_tpu.models.config import get_config as j_get_config
from flatquant_tpu.models.llama import init_params as j_init_params
from flatquant_tpu.models.llama import llama_forward as j_llama_forward
from flatquant_tpu.quantize.bake import bake_model as j_bake_model
from flatquant_tpu.quantize.spec import W4A4KV4 as J_W4A4KV4
from flatquant_tpu.quantize.state import init_model_fq as j_init_model_fq
from flatquant_tpu.serving.batcher import ContinuousBatcher as JBatcher
from flatquant_tpu.serving.engine import (
    init_cache as j_init_cache,
    serving_decode_step as j_decode,
    serving_prefill as j_prefill,
)
from flatquant_tpu.serving.quantized import (
    build_serving_params as j_build_serving_params,
)
from flatquant_torch.parallel.launch import run_ranks

RANK_TIMEOUT_S = 240.0
FWD = {"fp_pp2": (4, 16), "fp_pp4": (6, 16), "eval_pp2": (4, 16),
       "fp_dp2_pp2": (8, 16)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _build(cfg, params, fq):
    bp, bfq = jax.jit(functools.partial(j_bake_model, cfg, J_W4A4KV4))(
        params, fq)
    return jax.jit(functools.partial(
        j_build_serving_params, cfg, J_W4A4KV4, dtype=jnp.float32,
        merge_projections=True))(bp, bfq)


@pytest.fixture(scope="module")
def jax_side():
    cfg = dataclasses.replace(j_get_config("tiny-llama"), num_layers=4)
    params = j_init_params(cfg, seed=0)
    fq = j_init_model_fq(cfg, J_W4A4KV4, seed=0)
    sharp = dict(params, lm_head=params["lm_head"] * 6.0)
    rng = np.random.default_rng(0)
    out = dict(cfg=cfg, params=params, fq1=j_init_model_fq(
        cfg, J_W4A4KV4, seed=1), sp=_build(cfg, params, fq),
        batcher_sp=_build(cfg, sharp, fq),
        toks=rng.integers(0, cfg.vocab_size, (4, 12)).astype(np.int32),
        # 8 rows: 2 microbatches of 4, 2 rows a dp rank (a one-row GEMM
        # sums in another order than a multi-row one on the CPU, so one
        # row a rank would not be bit-equal to the sequential batch)
        dp_toks=np.random.default_rng(5).integers(
            0, cfg.vocab_size, (8, 12)).astype(np.int32),
        fwd_toks={k: rng.integers(0, cfg.vocab_size, s).astype(np.int32)
                  for k, s in FWD.items()})
    rng = np.random.default_rng(0)
    out["prompts"] = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
                      for n in (5, 7, 4)]
    rng = np.random.default_rng(3)
    out["chunk_prompts"] = [rng.integers(0, cfg.vocab_size, (n,))
                            .astype(np.int32) for n in (9, 6)]
    return out


@pytest.fixture(scope="module")
def pp_ranks(jax_side, tmp_path_factory):
    payload = dict(sp=_np(jax_side["sp"]),
                   batcher_sp=_np(jax_side["batcher_sp"]),
                   params=_np(jax_side["params"]), fq=_np(jax_side["fq1"]),
                   toks=jax_side["toks"], dp_toks=jax_side["dp_toks"],
                   fwd_toks=jax_side["fwd_toks"],
                   prompts=jax_side["prompts"],
                   chunk_prompts=jax_side["chunk_prompts"])
    return run_ranks(cases.pp_cases, 4, args=(payload,), device="cpu",
                     threads=1, timeout_s=RANK_TIMEOUT_S,
                     rendezvous_dir=str(tmp_path_factory.mktemp("rdzv")))


def _jax_serving(side, cache_mode, toks=None):
    cfg, sp = side["cfg"], side["sp"]
    toks = side["toks"] if toks is None else toks
    cache = j_init_cache(cfg, toks.shape[0], 16, dtype=jnp.float32,
                         mode=cache_mode)
    logits, cache = j_prefill(cfg, J_W4A4KV4, sp, jnp.asarray(toks), cache,
                              use_kernel=False, max_len=16,
                              compute_dtype=jnp.float32)
    outs = [np.asarray(logits)]
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    for pos in (toks.shape[1], toks.shape[1] + 1):
        logits, cache = j_decode(cfg, J_W4A4KV4, sp, tok, cache,
                                 jnp.int32(pos), use_kernel=False,
                                 max_len=16, compute_dtype=jnp.float32)
        outs.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    return outs


@pytest.mark.parametrize("pp", [2, 4])
@pytest.mark.parametrize("cache_mode", ["bf16", "int4", "paged"])
def test_pipeline_real_quant_serving_exact(jax_side, pp_ranks, pp,
                                           cache_mode):
    """The packed engine pipelined over pp stages (2 microbatches,
    prefill + 2 decode steps) equals the sequential engine bit for bit on
    every rank, stage caches included (each stage writes only its own
    layers and microbatches), and JAX's sequential engine within 1e-5
    (tests/test_pipeline.py:76)."""
    want = _jax_serving(jax_side, cache_mode)
    for rank, res in enumerate(pp_ranks):
        got, seq = res[f"serve_pp{pp}_{cache_mode}"]
        for i, (g, s, w) in enumerate(zip(got, seq, want)):
            np.testing.assert_array_equal(g, s, err_msg=f"rank {rank} {i}")
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def _jax_dp_prefill(side, cache_mode):
    """JAX's pipeline_serving_forward(dp_axis="dp") prefill of the 4
    prompts on a pp 2 x dp 2 mesh of the host's CPU devices: last-token
    logits [4, V]. This is as far as JAX's dp serving runs: its stage body
    cuts a whole microbatch's cache rows (B / M) beside a hidden state of
    B / M / dp rows, which broadcasts only at one row a rank and leaves
    the slot caches wrong, so its decode steps fail in the attention's
    reshape, and 8 prompts fail at once."""
    from flatquant_tpu.parallel.mesh import make_mesh as j_make_mesh
    from flatquant_tpu.parallel.pipeline import (
        pipeline_serving_forward as j_pipe)

    cfg = side["cfg"]
    mesh = j_make_mesh({"pp": 2, "dp": 2}, devices=jax.devices()[:4])
    cache = j_init_cache(cfg, 4, 16, dtype=jnp.float32, mode=cache_mode)
    logits, _ = j_pipe(cfg, J_W4A4KV4, side["sp"], jnp.asarray(side["toks"]),
                       cache, jnp.int32(0), "prefill", mesh,
                       n_microbatches=2, use_kernel=False, max_len=16,
                       compute_dtype=jnp.float32, dp_axis="dp")
    return np.asarray(logits)


@pytest.mark.parametrize("cache_mode", ["bf16", "int4", "paged"])
def test_pipeline_serving_dp_exact(jax_side, pp_ranks, cache_mode):
    """pp 2 x dp 2 serving of 8 prompts (each dp rank its block of every
    microbatch's rows; bf16 and int4 slot caches cut to the rank's rows,
    the paged pool whole and written through the rank's table rows),
    prefill + 2 decode steps at per-slot positions: bit-equal on every
    rank to the sequential engine, the rank's cache rows bit-equal to the
    sequential cache's, within 1e-5 of JAX's sequential engine. The
    prefill of the 4 prompts is within 1e-5 of JAX's
    pipeline_serving_forward(dp_axis="dp") and bit-equal to the port's
    sequential prefill of them."""
    want = _jax_serving(jax_side, cache_mode, jax_side["dp_toks"])
    want4 = _jax_serving(jax_side, cache_mode)[0]
    want_dp = _jax_dp_prefill(jax_side, cache_mode)
    np.testing.assert_allclose(want_dp, want4, rtol=1e-5, atol=1e-5)
    for rank, res in enumerate(pp_ranks):
        got, seq, cache_same = res[f"serve_dp2_pp2_{cache_mode}"]
        assert cache_same, f"rank {rank}: cache rows differ"
        for i, (g, s, w) in enumerate(zip(got, seq, want)):
            np.testing.assert_array_equal(g, s, err_msg=f"rank {rank} {i}")
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        got4 = res[f"prefill4_dp2_pp2_{cache_mode}"]
        np.testing.assert_array_equal(
            got4, res[f"serve_pp2_{cache_mode}"][1][0])
        np.testing.assert_allclose(got4, want_dp, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(FWD))
def test_pipeline_llama_forward_exact(jax_side, pp_ranks, name):
    """pipeline_llama_forward (fp at pp 2 and pp 4 with 3 microbatches,
    eval mode with the FQ state, and dp 2 x pp 2) equals llama_forward
    bit for bit, and JAX's llama_forward within 1e-5."""
    cfg = jax_side["cfg"]
    kw = {}
    if name.startswith("eval"):
        kw = dict(fq=jax_side["fq1"], fq_cfg=J_W4A4KV4, mode="eval")
    want = np.asarray(j_llama_forward(
        cfg, jax_side["params"], jnp.asarray(jax_side["fwd_toks"][name]),
        compute_dtype=jnp.float32, **kw))
    for res in pp_ranks:
        got, seq = res["fwd_" + name]
        np.testing.assert_array_equal(got, seq)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["bf16", "int4", "paged", "chunked"])
def test_batcher_pp_matches_plain(jax_side, pp_ranks, name):
    """Requests through 2 slots under pp = 2 (prefill and chunks as one
    microbatch, decode as 2) give the plain batcher's greedy tokens on
    every rank, and JAX's plain batcher's (tests/test_batcher_pp.py)."""
    cfg = jax_side["cfg"]
    mode = "int4" if name == "chunked" else name
    kw = dict(prefill_chunk=4) if name == "chunked" else {}
    prompts = (jax_side["chunk_prompts"] if name == "chunked"
               else jax_side["prompts"])
    n_new = (5, 5) if name == "chunked" else (6, 4, 5)
    jb = JBatcher(cfg, J_W4A4KV4, jax_side["batcher_sp"], batch_slots=2,
                  max_len=32, cache_mode="int4" if mode == "paged" else mode,
                  **kw)
    rids = [jb.submit(p, n) for p, n in zip(prompts, n_new)]
    res_j = jb.run(max_steps=300)
    want = [res_j[r] for r in rids]
    for res in pp_ranks:
        plain, piped = res["batcher_" + name]
        assert piped == plain == want
        assert res["stage_layers"] == cfg.num_layers // 2
