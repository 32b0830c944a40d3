"""Sequence parallelism in the port (flatquant_torch/parallel/sequence.py:
ring attention, the sequence-parallel serving prefill, the prefill ->
decode handoff, the sequence-parallel llama forward) against JAX's
(tests/test_sequence_parallel.py).

The port runs four gloo ranks on the CPU in one spawn
(tests/_torch_par_cases.py sp_cases), as sp = 4 and as dp 2 x sp 2; each
returns its chunk, and the test puts the chunks back in order. JAX's
tolerances: ring attention within 2e-5 of dense causal attention, the
sp forward and the sp prefill within 2e-4 of single-device (only the
softmax's summation order differs), the gathered cache within 2e-4 of the
single-device prefill's, and the greedy continuation after the handoff
(bf16 and int4 caches) equal to the single-device one.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import _torch_par_cases as cases
from flatquant_tpu.kernels.prefill_attention import dense_causal_attention
from flatquant_tpu.models.config import get_config as j_get_config
from flatquant_tpu.models.llama import init_params as j_init_params
from flatquant_tpu.models.llama import llama_forward as j_llama_forward
from flatquant_tpu.quantize.bake import bake_model as j_bake_model
from flatquant_tpu.quantize.spec import W4A4KV4 as J_W4A4KV4
from flatquant_tpu.quantize.state import init_model_fq as j_init_model_fq
from flatquant_tpu.serving.engine import (
    init_cache as j_init_cache,
    serving_all_logits as j_all_logits,
    serving_decode_step as j_decode,
    serving_prefill as j_prefill,
)
from flatquant_tpu.serving.quantized import (
    build_serving_params as j_build_serving_params,
)
from flatquant_torch.parallel.launch import run_ranks

RANK_TIMEOUT_S = 240.0


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _serving(cfg, params):
    fq = j_init_model_fq(cfg, J_W4A4KV4, seed=0)
    bp, bfq = jax.jit(functools.partial(j_bake_model, cfg, J_W4A4KV4))(
        params, fq)
    return jax.jit(functools.partial(
        j_build_serving_params, cfg, J_W4A4KV4, dtype=jnp.float32,
        merge_projections=True))(bp, bfq)


@pytest.fixture(scope="module")
def jax_side():
    cfg = j_get_config("tiny-llama")
    params = j_init_params(cfg, seed=0)
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    params2 = j_init_params(cfg2, seed=0)
    rng = np.random.default_rng(1)
    qkv = {"q": rng.standard_normal((2, 64, 4, 16)).astype(np.float32),
           "k": rng.standard_normal((2, 64, 2, 16)).astype(np.float32),
           "v": rng.standard_normal((2, 64, 2, 16)).astype(np.float32)}
    return dict(
        cfg=cfg, cfg2=cfg2, params2=params2,
        fq2=j_init_model_fq(cfg2, J_W4A4KV4, seed=0), qkv=qkv,
        fwd_toks=np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 32)).astype(np.int32),
        sp=_serving(cfg, params),
        sp_sharp=_serving(cfg, dict(params,
                                    lm_head=params["lm_head"] * 6.0)),
        toks=np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 32)).astype(np.int32),
        handoff_toks=np.random.default_rng(5).integers(
            0, cfg.vocab_size, (2, 32)).astype(np.int32))


@pytest.fixture(scope="module")
def sp_ranks(jax_side, tmp_path_factory):
    payload = {k: jax_side[k] for k in ("qkv", "fwd_toks", "toks",
                                        "handoff_toks")}
    payload.update(params=_np(jax_side["params2"]), fq=_np(jax_side["fq2"]),
                   sp=_np(jax_side["sp"]), sp_sharp=_np(jax_side["sp_sharp"]))
    return run_ranks(cases.sp_cases, 4, args=(payload,), device="cpu",
                     threads=1, timeout_s=RANK_TIMEOUT_S,
                     rendezvous_dir=str(tmp_path_factory.mktemp("rdzv")))


def _sp4(ranks, key):
    """The sp = 4 chunks of `key`, in sequence order, on dim 1."""
    order = sorted(ranks, key=lambda r: r["sp4_index"])
    return np.concatenate([r[key] for r in order], axis=1)


def test_ring_attention_matches_dense(jax_side, sp_ranks):
    qkv = {k: jnp.asarray(v) for k, v in jax_side["qkv"].items()}
    ref = dense_causal_attention(qkv["q"], qkv["k"], qkv["v"], 0.25,
                                 compute_dtype=jnp.float32)
    np.testing.assert_allclose(_sp4(sp_ranks, "ring"), np.asarray(ref),
                               atol=2e-5)


@pytest.mark.parametrize("mode", ["fp", "eval"])
def test_sp_forward_matches_sequential(jax_side, sp_ranks, mode):
    """dp 2 x sp 2: each rank's [1, 16, V] block of the sp forward equals
    JAX's llama_forward's within 2e-4."""
    kw = (dict(fq=jax_side["fq2"], fq_cfg=J_W4A4KV4, mode="eval")
          if mode == "eval" else {})
    ref = np.asarray(j_llama_forward(
        jax_side["cfg2"], jax_side["params2"],
        jnp.asarray(jax_side["fwd_toks"]), compute_dtype=jnp.float32, **kw))
    for res in sp_ranks:
        d, s = res["dpsp_index"]
        np.testing.assert_allclose(res["fwd_" + mode],
                                   ref[d:d + 1, s * 16:(s + 1) * 16],
                                   rtol=2e-4, atol=2e-4)


def test_sp_serving_prefill_matches_single_device(jax_side, sp_ranks):
    """The real-quant prefill over sp = 4: the chunks' logits equal JAX's
    serving_all_logits and the gathered cache JAX's single-device
    prefill cache, within 2e-4."""
    cfg, sp = jax_side["cfg"], jax_side["sp"]
    toks = jnp.asarray(jax_side["toks"])
    cache = j_init_cache(cfg, 2, 32, dtype=jnp.float32, mode="bf16")
    _, ref_cache = j_prefill(cfg, J_W4A4KV4, sp, toks, cache,
                             use_kernel=False, max_len=32,
                             compute_dtype=jnp.float32)
    ref_all = j_all_logits(cfg, J_W4A4KV4, sp, toks, use_kernel=False,
                           compute_dtype=jnp.float32)
    np.testing.assert_allclose(_sp4(sp_ranks, "prefill_logits"),
                               np.asarray(ref_all), rtol=2e-4, atol=2e-4)
    for res in sp_ranks:
        for key in ("k", "v"):
            np.testing.assert_allclose(res["prefill_cache"][key],
                                       np.asarray(ref_cache[key]),
                                       rtol=2e-4, atol=2e-4)


def test_sp_prefill_decode_handoff(jax_side, sp_ranks):
    """sp prefill -> all-gather over sp -> decode: the greedy continuation
    through the gathered bf16 cache and through the re-packed int4 cache
    equals JAX's single-device prefill + decode, on every rank."""
    cfg, sp = jax_side["cfg"], jax_side["sp_sharp"]
    toks = jnp.asarray(jax_side["handoff_toks"])
    cache = j_init_cache(cfg, 2, 48, dtype=jnp.float32, mode="bf16")
    last, cache = j_prefill(cfg, J_W4A4KV4, sp, toks, cache,
                            use_kernel=False, max_len=48,
                            compute_dtype=jnp.float32)
    outs = [np.asarray(jnp.argmax(last, -1))]
    tok = jnp.argmax(last, -1)[:, None].astype(jnp.int32)
    for i in range(4):
        last, cache = j_decode(cfg, J_W4A4KV4, sp, tok, cache,
                               jnp.int32(32 + i), use_kernel=False,
                               max_len=48, compute_dtype=jnp.float32)
        outs.append(np.asarray(jnp.argmax(last, -1)))
        tok = jnp.argmax(last, -1)[:, None].astype(jnp.int32)
    want = np.stack(outs, 1)
    for res in sp_ranks:
        np.testing.assert_array_equal(res["handoff_bf16"], want)
        np.testing.assert_array_equal(res["handoff_int4"], want)
