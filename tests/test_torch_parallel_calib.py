"""Calibration under a mesh in the port (flatquant_torch/parallel/mesh.py
specs, parallel/tp_autograd.py, models/llama.py and models/deepseek.py
under tp / dp / ep, calib/trainer.py's mesh) against JAX's sharded
calibration (tests/test_parallel.py).

JAX builds the models (tiny-llama, its tp = 1 and shard-aligned tp = 2
FQ state; TINY_DEEPSEEK) and runs its single-device forwards and its
calibration step in process; the port runs every mesh case in one spawn
of four gloo ranks on the CPU (tests/_torch_calib_cases.py calib_cases).
Tolerances are JAX's own: the sharded calib forward within 2e-4 (tp = 1
state) and 3e-4 (shard-aligned; DeepSeek), one step's MSE within rtol
1e-5 and its state within rtol = atol = 5e-4. A 2-layer `calibrate` and
a `calibrate_deepseek` pass under the mesh are held to the port's own
single-device runs at the step's tolerances. Each autograd Function's
gradient is held to the single-process gradient of the unsharded op, and
the per-rank slices of both spec rules to JAX's PartitionSpec slices on
its 8-device CPU mesh.
"""

import dataclasses
import functools

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import NamedSharding

import _torch_calib_cases as cases
from flatquant_tpu.calib import gptq as jg
from flatquant_tpu.calib.trainer import build_labels as j_build_labels
from flatquant_tpu.calib.trainer import make_optimizer as j_make_optimizer
from flatquant_tpu.models import deepseek as jds
from flatquant_tpu.models.config import get_config as j_get_config
from flatquant_tpu.models.llama import causal_mask as j_causal_mask
from flatquant_tpu.models.llama import init_params as j_init_params
from flatquant_tpu.models.llama import llama_forward as j_llama_forward
from flatquant_tpu.models.llama import llama_layer as j_llama_layer
from flatquant_tpu.models.llama import rope_tables as j_rope_tables
from flatquant_tpu.parallel import mesh as jmesh
from flatquant_tpu.quantize import bake as jbake
from flatquant_tpu.quantize.spec import W4A4 as J_W4A4
from flatquant_tpu.quantize.spec import W4A4KV4 as J_W4A4KV4
from flatquant_tpu.quantize.state import init_model_fq as j_init_model_fq
from flatquant_tpu.quantize.state import slice_layer
from flatquant_torch.calib.trainer import calibrate
from flatquant_torch.models import deepseek as ds
from flatquant_torch.models.config import get_config
from flatquant_torch.parallel import mesh as tmesh
from flatquant_torch.parallel.launch import run_ranks
from flatquant_torch.quantize.spec import W4A4, W4A4KV4
from flatquant_torch.utils.convert import (
    from_jax_ds_fq,
    from_jax_ds_serving_params,
    from_jax_fq,
    from_jax_params,
)
from flatquant_torch.utils.tree import tree_leaves

RANK_TIMEOUT_S = 240.0
# one step a layer: every step starts from the same state on both sides,
# as JAX's sharded-step test's (a second AdamW step amplifies float-level
# differences chaotically, on one device too)
RECIPE = dict(deactive_amp=True, epochs=1, nsamples=4, cali_bsz=4)
DS_RECIPE = dict(deactive_amp=True, epochs=1, nsamples=2, cali_bsz=2)
# DeepSeek generation: new tokens and the cache length
GEN_NEW, GEN_LEN = 4, 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _j_step(cfg, fq_cfg, params, fq, x_np, total_steps):
    """JAX's single-device calibration step of layer 0
    (tests/test_parallel.py:184): (MSE, the new state's leaves)."""
    lp, fq_l = slice_layer(params["layers"], 0), slice_layer(fq, 0)
    tx = j_make_optimizer(fq_cfg, j_build_labels(fq_l),
                          total_steps=total_steps)
    S = x_np.shape[1]
    cos, sin = j_rope_tables(cfg, jnp.arange(S))
    mask = j_causal_mask(S)

    def train_step(fq_l, opt_state, lp, x):
        teacher = j_llama_layer(cfg, None, "fp", lp, None, x, cos, sin, mask)

        def loss_fn(fq_l):
            out = j_llama_layer(cfg, fq_cfg, "calib", lp, fq_l, x, cos, sin,
                                mask)
            mse = jnp.mean((out - teacher) ** 2)
            return mse / jax.lax.stop_gradient(mse), mse

        (_, mse), grads = jax.value_and_grad(loss_fn, has_aux=True)(fq_l)
        updates, opt_state = tx.update(grads, opt_state, fq_l)
        return optax.apply_updates(fq_l, updates), mse

    new, mse = jax.jit(train_step)(fq_l, tx.init(fq_l), lp,
                                   jnp.asarray(x_np))
    return float(mse), [np.asarray(a) for a in jax.tree.leaves(new)]


def _fn_inputs():
    """x [4, 8] with tied extrema planted across and inside the tp = 4
    shards (two columns each), and the loss weights c [8, 8]."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 8)).astype(np.float32)
    x[0, 1] = x[0, 5] = 3.0  # max tied across shards 0 and 2
    x[1, 2] = x[1, 3] = 3.5  # max tied inside shard 1
    x[2, 0] = x[2, 7] = -4.0  # min tied across shards 0 and 3
    x[3, 4] = x[3, 5] = -4.5  # min tied inside shard 2
    c = rng.standard_normal((8, 8)).astype(np.float32)
    return x, c


@pytest.fixture(scope="module")
def jax_side():
    cfg = j_get_config("tiny-llama")
    params = j_init_params(cfg, seed=0)
    fq = {tp: j_init_model_fq(cfg, J_W4A4KV4, seed=0, tp=tp) for tp in (1, 2)}
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32)
    step_x = np.random.default_rng(1).standard_normal(
        (4, 16, cfg.hidden_size)).astype(np.float32)
    fwd = jax.jit(functools.partial(
        j_llama_forward, cfg, fq_cfg=J_W4A4KV4, mode="calib",
        compute_dtype=jnp.float32))
    out = dict(
        cfg=cfg, params=params, toks=toks, step_x=step_x,
        forward={tp: np.asarray(fwd(params, jnp.asarray(toks), fq=fq[tp]))
                 for tp in (1, 2)},
        step={tp: _j_step(cfg, J_W4A4KV4, params, fq[tp], step_x, 10)
              for tp in (1, 2)},
        calib_toks=np.random.default_rng(2).integers(
            0, cfg.vocab_size, (4, 16)).astype(np.int32),
        fq=fq)
    dcfg = jds.TINY_DEEPSEEK
    dparams = jds.init_ds_params(dcfg, seed=0)
    dfq = jds.init_ds_fq(dcfg, J_W4A4, seed=0)
    dtoks = np.random.default_rng(0).integers(
        0, dcfg.vocab_size, (4, 16)).astype(np.int32)
    dfwd = jax.jit(functools.partial(
        jds.deepseek_forward, dcfg, fq_cfg=J_W4A4, mode="calib",
        compute_dtype=jnp.float32))
    out["ds"] = dict(cfg=dcfg, params=dparams, fq=dfq, toks=dtoks,
                     forward=np.asarray(dfwd(dparams, jnp.asarray(dtoks),
                                             fq=dfq)),
                     gen_prompt=np.random.default_rng(3).integers(
                         0, dcfg.vocab_size, (2, 6)).astype(np.int32))
    # generation on the sharpened head (greedy ties), JAX's fp mode (its
    # calib-mode generate compiles for ~20 s on the CPU)
    out["ds"]["generate"] = jds.deepseek_generate(
        dcfg, dict(dparams, head=dparams["head"] * 6.0), None, J_W4A4,
        out["ds"]["gen_prompt"], max_new_tokens=GEN_NEW, max_len=GEN_LEN,
        mode="fp", compute_dtype=jnp.float32)
    # GPTQ: baked tiny-llama (a state as wide as the dim, a shard-aligned
    # one), JAX's gptq_model on each
    out["gptq_train"] = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)
    bake = jax.jit(functools.partial(jbake.bake_model, cfg, J_W4A4KV4))
    out["gptq"] = {}
    for tp in (1, 2):
        bp, bfq = bake(params, fq[tp])
        out["gptq"][tp] = dict(bp=bp, bfq=bfq, jax=jg.gptq_model(
            cfg, J_W4A4KV4, bp, bfq, out["gptq_train"], log=lambda m: None))
    return out


def _rq_weight():
    """w [6, 32] for the row-reduced quantizers at tp = 4 (8 in features a
    shard): each row's extrema planted in different shards, one row all
    but zero outside shard 3."""
    w = np.random.default_rng(11).standard_normal((6, 32)).astype(np.float32)
    w[0, 3], w[0, 30] = 4.0, -3.0
    w[1, 12], w[1, 20] = -5.0, 2.5
    w[2, :24] = 0.0
    return w


def _payload(jax_side):
    d = jax_side["ds"]
    x, c = _fn_inputs()
    return dict(
        fn_x=x, fn_c=c, rq_w=_rq_weight(), recipe=RECIPE,
        ds_recipe=DS_RECIPE,
        llama=dict(params=_np(jax_side["params"]),
                   fq={tp: _np(f) for tp, f in jax_side["fq"].items()},
                   toks=jax_side["toks"], step_x=jax_side["step_x"],
                   calib_toks=jax_side["calib_toks"]),
        ds=dict(cfg=dataclasses.asdict(d["cfg"]), params=_np(d["params"]),
                fq=_np(d["fq"]), toks=d["toks"], gen_prompt=d["gen_prompt"]),
        gptq=dict(bp={tp: _np(g["bp"]) for tp, g in jax_side["gptq"].items()},
                  bfq={tp: _np(g["bfq"])
                       for tp, g in jax_side["gptq"].items()},
                  train=jax_side["gptq_train"]))


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """Every mesh case in 4 gloo ranks, one spawn."""
    return run_ranks(cases.calib_cases, 4, args=(_payload(jax_side),),
                     device="cpu", threads=1, timeout_s=RANK_TIMEOUT_S,
                     rendezvous_dir=str(tmp_path_factory.mktemp("rdzv")))


def _close_leaves(got, want, rtol, atol, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                   err_msg=f"{what} leaf {i}")


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


def _jax_slices(tree, specs, mesh, rank):
    """The block of every leaf that JAX's NamedSharding puts on the
    mesh's device `rank` (row-major, as the port's ranks)."""
    dev = mesh.devices.flat[rank]

    def one(a, s):
        arr = jax.device_put(a, NamedSharding(mesh, s))
        return next(np.asarray(sh.data) for sh in arr.addressable_shards
                    if sh.device == dev)

    return jax.tree.map(one, tree, specs)


@pytest.mark.parametrize("axes,tp_size", [
    ({"dp": 2, "tp": 4}, None), ({"dp": 2, "tp": 4}, 4),
    ({"dp": 4, "tp": 2}, 2)])
def test_llama_specs_slice_as_jax(jax_side, axes, tp_size):
    """The port's per-rank blocks of every fp param equal JAX's
    PartitionSpec blocks, the head-granular rule included (tp = 4 over
    tiny-llama's 2 kv heads: wk / wv replicate, tests/test_parallel.py
    :184)."""
    cfg, params = jax_side["cfg"], jax_side["params"]
    jspecs = jmesh.llama_param_specs(cfg, params, tp_size=tp_size)
    jm = jmesh.make_mesh(axes)
    tparams = from_jax_params(_np(params), "cpu")
    tspecs = tmesh.llama_param_specs(get_config("tiny-llama"), tparams,
                                     tp_size=tp_size)
    if tp_size == 4:
        assert tspecs["layers"][0]["wk"] is None
        assert tspecs["layers"][0]["wq"] == ("tp", 0)
    for r in range(8):
        want = _jax_slices(params, jspecs, jm, r)
        got = tmesh.shard_tree(tparams, tspecs,
                               tmesh.plan_mesh(axes, r, "cpu"))
        for key in ("embed", "final_norm_w"):
            np.testing.assert_array_equal(got[key].numpy(), want[key])
        for k, stacked in want["layers"].items():
            for layer in range(cfg.num_layers):
                np.testing.assert_array_equal(
                    got["layers"][layer][k].numpy(), stacked[layer],
                    err_msg=f"rank {r} layer {layer} {k}")


def test_deepseek_specs_slice_as_jax(jax_side):
    """deepseek_param_specs: MLA heads and the dense / shared FFN over
    tp, routed experts over ep, the rest replicated, block for block as
    JAX's on a {dp 2, ep 2, tp 2} mesh."""
    d = jax_side["ds"]
    axes = {"dp": 2, "ep": 2, "tp": 2}
    jm = jmesh.make_mesh(axes)
    jspecs = jmesh.deepseek_param_specs(d["cfg"], d["params"])
    tparams = from_jax_ds_serving_params(_np(d["params"]), "cpu")
    tspecs = tmesh.deepseek_param_specs(None, tparams)
    for r in range(8):
        want = _jax_slices(d["params"], jspecs, jm, r)
        got = tmesh.shard_tree(tparams, tspecs,
                               tmesh.plan_mesh(axes, r, "cpu"))
        for key in ("embed", "final_norm", "head"):
            np.testing.assert_array_equal(got[key].numpy(), want[key])
        for part in ("dense_layers", "moe_layers"):
            for k, stacked in want[part].items():
                for i, lp in enumerate(got[part]):
                    np.testing.assert_array_equal(
                        lp[k].numpy(), stacked[i],
                        err_msg=f"rank {r} {part}[{i}] {k}")


def test_spec_helpers():
    """A spec naming an axis the mesh lacks replicates; batch_spec and
    replicated_specs; the former stubs no longer raise."""
    m = tmesh.plan_mesh({"ep": 2}, 1, "cpu")
    t = torch.arange(8.0).reshape(4, 2)
    assert tmesh.shard_tree(t, ("tp", 0), m) is t
    assert torch.equal(tmesh.shard_tree(t, ("ep", 0), m), t[2:])
    assert tmesh.batch_spec() == ("dp", 0)
    assert tmesh.replicated_specs({"a": [t, t]}) == {"a": [None, None]}
    assert tmesh.mesh_axis(m, "tp") is None and tmesh.mesh_axis(None, "ep") \
        is None


# ---------------------------------------------------------------------------
# the autograd Functions
# ---------------------------------------------------------------------------


def _unsharded(name, x, c):
    """The single-process gradient of the unsharded op with respect to
    x (the whole of it)."""
    x = x.clone().requires_grad_(True)
    if name == "copy_to":
        loss = (x @ c.T).sum()
    elif name == "reduce_from":
        y = x @ c.T
        loss = (y * y).sum()
    elif name in ("gather_from", "scatter_to"):
        loss = (x * x * c[:4, :8]).sum()
    else:
        m = (x.amax if name == "shard_max" else x.amin)(dim=-1, keepdim=True)
        loss = (m * c[:4, :4].sum(1, keepdim=True)).sum()
    loss.backward()
    return x.grad.numpy()


@pytest.mark.parametrize("name", ["copy_to", "reduce_from", "gather_from",
                                  "scatter_to", "shard_max", "shard_min"])
def test_autograd_function_gradient(ranks, name):
    """Each Function's gradient on every rank of tp = 4 equals the
    unsharded op's: whole for a replicated input, this rank's block for
    a sharded one. The extrema's gradient is shared among ties across
    and inside shards, as amax shares it."""
    x, c = (torch.as_tensor(a) for a in _fn_inputs())
    want = _unsharded(name, x, c)
    for r, res in enumerate(ranks):
        got = res["functions"][name]
        if name in ("copy_to", "scatter_to"):
            ref = want
        else:
            ref = want[:, 2 * r:2 * r + 2]
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6,
                                   err_msg=f"rank {r}")


def test_row_reduced_quantizers_match_jax(ranks):
    """core/quant.py's weight scales (with and without the MSE shrink
    search, symmetric and not) and per-token activation scales, on each
    rank's block of the in features at tp = 4 with row_reducer's hook,
    equal the single process's on the whole rows and JAX's
    weight_find_params / act_scale_zero on them (rtol 1e-6; the search's
    error sums differ in order only)."""
    from flatquant_tpu.core import quant as jq

    w = _rq_weight()
    whole = cases.row_quant(torch.as_tensor(w), None)
    for sym in (True, False):
        for mse in (False, True):
            name = f"w_sym{sym}_mse{mse}"
            want = jq.weight_find_params(jnp.asarray(w), jq.WeightQuantCfg(
                bits=4, sym=sym, mse=mse))
            for a, b in zip(whole[name], want):
                np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                           err_msg=name)
        want = jq.act_scale_zero(jnp.asarray(w), jq.ActQuantCfg(
            bits=4, sym=sym))
        for a, b in zip(whole[f"a_sym{sym}"], want):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6)
    for r, res in enumerate(ranks):
        for name, pair in whole.items():
            for a, b in zip(res["functions"]["row_quant"][name], pair):
                np.testing.assert_allclose(a, b, rtol=1e-6,
                                           err_msg=f"rank {r} {name}")


# ---------------------------------------------------------------------------
# forwards, the step and calibration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp_state,tol", [(1, 2e-4), (2, 3e-4)])
def test_sharded_llama_forward_matches_jax(jax_side, ranks, tp_state, tol):
    """The calib-mode llama_forward on {dp 2, tp 2} (tests/test_parallel.py
    :28 and :129): transforms as wide as the dim (tp = 1 state) and
    shard-aligned ones (tp = 2, with a vocab-parallel embedding), every
    rank's logits against JAX's single device."""
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[f"forward_tp{tp_state}"],
                                   jax_side["forward"][tp_state], rtol=tol,
                                   atol=tol, err_msg=f"rank {r}")


def test_sharded_deepseek_forward_matches_jax(jax_side, ranks):
    """DeepSeek's calib forward on {ep 2, tp 2}: MLA heads and the dense
    and shared FFNs over tp, the routed experts over ep
    (tests/test_parallel.py:97, 3e-4)."""
    for r, res in enumerate(ranks):
        assert res["experts"] == jax_side["ds"]["cfg"].n_routed_experts // 2
        np.testing.assert_allclose(res["ds_forward"],
                                   jax_side["ds"]["forward"], rtol=3e-4,
                                   atol=3e-4, err_msg=f"rank {r}")


@pytest.mark.parametrize("tp_state", [1, 2])
def test_sharded_calib_step_matches_jax(jax_side, ranks, tp_state):
    """One calibration step (fp teacher, calib student, normalised MSE,
    backward, AdamW) on {dp 2, tp 2} against JAX's single-device step
    (tests/test_parallel.py:184): MSE within rtol 1e-5, state within
    rtol = atol = 5e-4, on every rank."""
    mse_j, leaves_j = jax_side["step"][tp_state]
    for r, res in enumerate(ranks):
        mse, leaves = res[f"step_tp{tp_state}"]
        np.testing.assert_allclose(mse, mse_j, rtol=1e-5)
        _close_leaves(leaves, leaves_j, 5e-4, 5e-4, f"rank {r}")


def test_sharded_calibrate_matches_single_device(jax_side, ranks):
    """A 2-layer float32 calibrate under {dp 2, tp 2} against the port's
    own single-device run: every step's MSE within rtol 1e-5, the state
    within rtol = atol = 5e-4, the same state on every rank."""
    cfg = get_config("tiny-llama")
    fq_cfg = dataclasses.replace(W4A4KV4, **RECIPE)
    hist = []
    ref = calibrate(cfg, fq_cfg, from_jax_params(_np(jax_side["params"]),
                                                 "cpu"),
                    from_jax_fq(_np(jax_side["fq"][1]), "cpu"),
                    jax_side["calib_toks"], log=lambda m: None, history=hist)
    want = [h["step_mse"] for h in hist]
    assert len(want) == cfg.num_layers and len(want[0]) == 1
    for r, res in enumerate(ranks):
        mses, leaves = res["calibrate"]
        np.testing.assert_allclose(mses, want, rtol=1e-5)
        _close_leaves(leaves, [t.numpy() for t in tree_leaves(ref)], 5e-4,
                      5e-4, f"rank {r}")
        for a, b in zip(leaves, ranks[0]["calibrate"][1]):
            np.testing.assert_array_equal(a, b)


def test_sharded_calibrate_deepseek_matches_single_device(jax_side, ranks):
    """calibrate_deepseek under {ep 2, tp 2} (JAX: "shard with
    deepseek_param_specs; run calibrate_deepseek unchanged") against the
    port's single-device pass, at the step's tolerances."""
    d = jax_side["ds"]
    fq_cfg = dataclasses.replace(W4A4, **DS_RECIPE)
    toks = d["toks"][:DS_RECIPE["nsamples"]]
    dfq = from_jax_ds_fq(_np(d["fq"]), "cpu")
    hist = []
    ref = ds.calibrate_deepseek(
        ds.DeepSeekConfig(**dataclasses.asdict(d["cfg"])), fq_cfg,
        from_jax_ds_serving_params(_np(d["params"]), "cpu"), dfq[0], dfq[1],
        toks, log=lambda m: None, history=hist)
    want = [h["step_mse"] for h in hist]
    for r, res in enumerate(ranks):
        mses, leaves = res["ds_calibrate"]
        np.testing.assert_allclose(mses, want, rtol=1e-5)
        _close_leaves(leaves, [t.numpy() for t in tree_leaves(ref)], 5e-4,
                      5e-4, f"rank {r}")


# ---------------------------------------------------------------------------
# the configurations JAX's GSPMD runs: DeepSeek generation, GPTQ and
# attn_fn under tp
# ---------------------------------------------------------------------------


def _close_up_to_ties(got, want, what):
    """float32 rows within 1e-4, but for rows a W4A4 rounding tie moved:
    at most 10% of the rows beyond 1e-4, every row within 1% of its norm
    (tests/test_torch_deepseek.py's bound for the DeepSeek forwards)."""
    got, want = np.asarray(got), np.asarray(want)
    d = np.abs(got - want).max(axis=-1)
    rel = (d / np.maximum(np.linalg.norm(want, axis=-1), 1e-30)).max()
    frac = (d > 1e-4).mean()
    assert frac <= 0.1 and rel <= 0.01, (what, frac, rel)


@pytest.mark.parametrize("mesh_name", ["dp2_tp2", "ep2_tp2"])
def test_sharded_deepseek_generate_matches_jax(jax_side, ranks, mesh_name):
    """deepseek_generate on TINY_DEEPSEEK's blocks under {dp 2, tp 2} and
    {ep 2, tp 2} (heads over tp, each rank the whole latent cache of its
    dp rows), head sharpened 6x: every rank's tokens equal JAX's
    deepseek_generate and the port's single device in mode "fp", and the
    single device's in "calib"; calib _ds_step's logits of the prefill
    and two decode steps within the DeepSeek port tests' bound of the
    single device's."""
    d = jax_side["ds"]
    cfg = ds.DeepSeekConfig(**dataclasses.asdict(d["cfg"]))
    params = from_jax_ds_serving_params(_np(d["params"]), "cpu")
    params = dict(params, head=params["head"] * 6.0)
    fq = from_jax_ds_fq(_np(d["fq"]), "cpu")
    prompt = torch.as_tensor(d["gen_prompt"]).long()
    want = {mode: ds.deepseek_generate(
        cfg, params, fq if mode == "calib" else None, W4A4, prompt,
        max_new_tokens=GEN_NEW, max_len=GEN_LEN, mode=mode,
        compute_dtype=torch.float32, device="cpu")
        for mode in ("fp", "calib")}
    np.testing.assert_array_equal(want["fp"], d["generate"])
    cache = ds.init_ds_cache(cfg, 2, GEN_LEN, torch.float32, device="cpu")
    logits, tok, pos = [], prompt, 0
    for _ in range(3):
        lg, cache = ds._ds_step(cfg, W4A4, "calib", params, fq, tok, cache,
                                pos, GEN_LEN, torch.float32)
        logits.append(lg.numpy())
        pos += tok.shape[1]
        tok = lg.argmax(-1, keepdim=True)
    for r, res in enumerate(ranks):
        toks, got = res["ds_generate"][mesh_name]
        for mode in want:
            np.testing.assert_array_equal(toks[mode], want[mode],
                                          err_msg=f"rank {r} {mode}")
        for i, (g, w) in enumerate(zip(got, logits)):
            _close_up_to_ties(g, w, f"rank {r} step {i}")


def _code_step(q):
    """Each weight's code step: its row's max |value| / 7
    (tests/test_torch_gptq.py)."""
    return np.abs(q).max(axis=1, keepdims=True) / 7.0 + 1e-12


GPTQ_KEYS = ("wq", "wk", "wv", "wo", "wup", "wgate", "wdown")


@pytest.mark.parametrize("state_tp", [1, 2])
def test_sharded_gptq_matches_single_device(jax_side, ranks, state_tp):
    """gptq_model under {dp 2, tp 2} on tiny-llama's baked blocks (a state
    as wide as the dim, and a shard-aligned one): every rank's blocks are
    the port's single-device GPTQ's blocks (llama_param_specs at tp = 2)
    with at most 1e-3 of the codes a step apart (float32 ties: the
    sharded forwards sum in another order) and the rest within 1e-3 of a
    step, and within tests/test_torch_gptq.py's bound of JAX's
    gptq_model (the same share of flipped codes, 1e-3 of a step)."""
    from flatquant_torch.calib.gptq import gptq_model

    cfg = get_config("tiny-llama")
    g = jax_side["gptq"][state_tp]
    bp = from_jax_params(_np(g["bp"]), "cpu")
    one = gptq_model(cfg, W4A4KV4, bp, from_jax_fq(_np(g["bfq"]), "cpu"),
                     jax_side["gptq_train"], log=lambda m: None)
    specs = tmesh.llama_param_specs(cfg, bp, tp_size=2)
    jwant = from_jax_params(_np(g["jax"]), "cpu")
    for r, res in enumerate(ranks):
        m = tmesh.plan_mesh({"dp": 2, "tp": 2}, r, "cpu")
        blocks = tmesh.shard_tree(one, specs, m)["layers"]
        jblocks = tmesh.shard_tree(jwant, specs, m)["layers"]
        flips = total = 0
        for i, layer in enumerate(res["gptq"][state_tp]):
            for key in GPTQ_KEYS:
                got = layer[key]
                for ref in (blocks[i][key].numpy(),
                            jblocks[i][key].numpy()):
                    assert got.shape == ref.shape, (r, i, key)
                    rel = np.abs(got - ref) / _code_step(ref)
                    flips += int((rel > 0.5).sum())
                    total += rel.size
                    assert rel[rel <= 0.5].max() <= 1e-3, (r, i, key)
        assert flips <= 1e-3 * total, f"rank {r}: {flips} of {total} codes"


def test_attn_fn_under_tp_equals_the_eager_core(ranks):
    """llama_layer under tp = 2 with attn_fn set to the eager core on the
    heads it receives equals attn_fn=None bit for bit, and receives this
    rank's heads (tiny-llama: 2 of 4 q heads, 1 of 2 kv heads)."""
    cfg = get_config("tiny-llama")
    for r, res in enumerate(ranks):
        same, heads = res["attn_fn"]
        assert same, f"rank {r}"
        assert heads == [(cfg.num_heads // 2, cfg.num_kv_heads // 2)]
