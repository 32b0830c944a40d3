"""DeepSeek's packed W4A4 serving under expert parallelism in the port
(flatquant_torch/parallel/mesh.py shard_ds_serving_params, the ep axis of
models/deepseek.py ds_batch_forward) against JAX's single-device batcher
(tests/test_ds_batcher.py:75).

Two gloo ranks on the CPU (tests/_torch_par_cases.py ep_cases), each with
half of TINY_DEEPSEEK's routed experts: the continuous batcher with the
DeepSeek hooks, whole and bucketed prefill on the dense-masked MoE and
the capacity-gather MoE, must give JAX's plain batcher's greedy tokens.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import _torch_par_cases as cases
from flatquant_tpu.models import deepseek as jds
from flatquant_tpu.quantize.spec import W4A4 as J_W4A4
from flatquant_tpu.serving.batcher import ContinuousBatcher as JBatcher
from flatquant_torch.models import deepseek as tds
from flatquant_torch.parallel.launch import run_ranks
from flatquant_torch.parallel.mesh import (
    deepseek_serving_specs,
    plan_mesh,
    shard_tree,
)
from flatquant_torch.utils.convert import from_jax_ds_serving_params

RANK_TIMEOUT_S = 240.0
N_NEW = (4, 3, 4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_side():
    cfg = jds.TINY_DEEPSEEK
    params = dict(jds.init_ds_params(cfg, seed=0))
    params["head"] = params["head"] * 6.0  # sharpen argmax against ties
    dfq, mfq = jds.init_ds_fq(cfg, J_W4A4, seed=0)
    sp, baked = jax.jit(functools.partial(
        jds.build_ds_serving_params, cfg, J_W4A4, dtype=jnp.float32))(
        params, dfq, mfq)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 8, 4)]
    want = {}
    for name, kw in (("whole", {}), ("bucket", dict(prefill_bucket=8)),
                     ("gather", {})):
        jcfg = (dataclasses.replace(cfg, moe_impl="gather")
                if name == "gather" else cfg)
        b = JBatcher(jcfg, J_W4A4, {"params": sp, "fq": baked},
                     batch_slots=2, max_len=32,
                     forward_fn=jds.ds_batch_forward,
                     init_cache_fn=jds.ds_init_batch_cache, **kw)
        rids = [b.submit(p, n) for p, n in zip(prompts, N_NEW)]
        got = b.run(max_steps=200)
        want[name] = [got[r] for r in rids]
    return dict(sp=sp, baked=baked, prompts=prompts, want=want)


@pytest.fixture(scope="module")
def ep_ranks(jax_side, tmp_path_factory):
    payload = dict(sp=_np(jax_side["sp"]), fq=_np(jax_side["baked"]),
                   prompts=jax_side["prompts"], n_new=N_NEW)
    return run_ranks(cases.ep_cases, 2, args=(payload,), device="cpu",
                     threads=1, timeout_s=RANK_TIMEOUT_S,
                     rendezvous_dir=str(tmp_path_factory.mktemp("rdzv")))


@pytest.mark.parametrize("name", ["whole", "bucket", "gather"])
def test_ds_batcher_under_ep_matches_jax(jax_side, ep_ranks, name):
    """Greedy tokens of the batcher under ep = 2 (each rank runs its half
    of the routed experts for every token, the partial sums all-reduced)
    equal JAX's single-device batcher's, on every rank."""
    for res in ep_ranks:
        assert res["experts"] == tds.TINY_DEEPSEEK.n_routed_experts // 2
        assert res[name] == jax_side["want"][name]


def test_deepseek_serving_specs_split_experts_only(jax_side):
    """The ep rule cuts every routed-expert tensor (codes and scales) on
    its expert dim and nothing else, as JAX's deepseek_serving_specs."""
    sp = from_jax_ds_serving_params(_np(jax_side["sp"]), "cpu")
    specs = deepseek_serving_specs(sp)
    E = tds.TINY_DEEPSEEK.n_routed_experts
    for r in range(2):
        local = shard_tree(sp, specs, plan_mesh({"ep": 2}, r, "cpu"))
        for lp, full in zip(local["moe_layers"], sp["moe_layers"]):
            for key, v in lp.items():
                if key in ("e_w1", "e_w2", "e_w3"):
                    for sub in ("wp", "scale"):
                        assert torch.equal(
                            v[sub], full[key][sub][r * E // 2:
                                                   (r + 1) * E // 2])
                    assert v["a_clip"][0] is full[key]["a_clip"][0]
                elif torch.is_tensor(v):
                    assert v is full[key], key
        assert local["dense_layers"][0]["wo"]["wp"] is \
            sp["dense_layers"][0]["wo"]["wp"]
