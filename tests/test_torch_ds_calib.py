"""DeepSeek's FlatQuant state, fake-quant forward, bake, packing and
calibration in the port (flatquant_torch/models/deepseek.py) against the
JAX package, on the CPU, on TINY_DEEPSEEK (q_lora, sigmoid gate with
groups and bias, 8 experts) with JAX's init_ds_params converted by
utils/convert.py.

Tolerances, and why:
  - init_ds_fq: bit for bit (both draw on the host in float64 numpy in
    the same order and round once); the statistics of the fp pass within
    1e-6 absolute (float32 sums in another order).
  - ds_layer in "calib" mode from the raw state: outputs within 2e-4
    relative to their largest value, gradients of each group (trans,
    diag, clip_w, clip_a) within 2e-3 by relative norm. The Cayley maps
    are float32 solves that JAX and torch round apart within cond(I -
    A/2) x 2^-23 (PR 16); every later float32 op carries that.
  - bake_ds_fq: each frozen matrix within 1e-4 of JAX's (the same bound).
  - build_ds_serving_params from JAX's frozen state (PR 16's rule): the
    codes equal but where the two folds' float32 values straddle a
    rounding tie (share at most 1e-3, one code), scales within 1e-6
    relative (the Kronecker fold sums in another order), a_clip equal.
  - calibrate_deepseek (float32, deactive_amp): every (layer, epoch)
    MSE within 15% of JAX's, the band tests/test_trainer_parity.py holds
    JAX to against the reference trainer.
"""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flatquant_tpu.calib.data import get_loaders
from flatquant_tpu.models import deepseek as jds
from flatquant_tpu.quantize.spec import FQConfig as JFQConfig
from flatquant_torch.calib import trainer as tt
from flatquant_torch.kernels.int4_matmul import unpack_weight_planar
from flatquant_torch.models import deepseek as tds
from flatquant_torch.quantize.spec import FQConfig
from flatquant_torch.utils.checkpoint import flatten_with_keys
from flatquant_torch.utils.convert import (
    from_jax_ds_fq,
    from_jax_ds_serving_params,
)
from flatquant_torch.utils.tree import tree_leaves

torch.set_num_threads(2)

RECIPE = dict(w_bits=4, a_bits=4, cali_trans=True, add_diag=True, lwc=True,
              lac=True, deactive_amp=True, cali_bsz=2)
JC, TC = jds.TINY_DEEPSEEK, tds.TINY_DEEPSEEK


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _slice(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


@pytest.fixture(scope="module")
def tiny():
    jp = jds.init_ds_params(JC, seed=1)
    return dict(jp=jp, tp=from_jax_ds_serving_params(_np(jp), "cpu"),
                jfq=JFQConfig(**RECIPE), fq=FQConfig(**RECIPE))


@pytest.mark.parametrize("flags,seed", [
    (dict(), 5),
    (dict(add_diag=False, lac=False), 0),
    (dict(direct_inv=True, w_bits=16, a_bits=16, lwc=False), 3),
])
def test_init_ds_fq_bit_equal(flags, seed):
    r = dict(RECIPE, **flags)
    want = from_jax_ds_fq(_np(jds.init_ds_fq(JC, JFQConfig(**r), seed=seed)),
                          "cpu")
    got = tds.init_ds_fq(TC, FQConfig(**r), seed=seed, device="cpu")
    assert [list(d) for d in got[0][0].values()] == \
        [list(tds.DSDenseLayerFQ[p]) for p in ("attn", "ffn")]
    assert list(got[1][0]["ffn"]) == list(tds.MoEFQ)
    a, b = tree_leaves(got), tree_leaves(want)
    assert len(a) == len(b) and a
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _inputs(S=16, B=2, seed=0):
    x = np.random.default_rng(seed).normal(size=(B, S, JC.dim))
    cos, sin = jds.ds_rope_tables(JC, S)
    mask = jnp.where(jnp.tril(jnp.ones((S, S), bool)), 0.0,
                     -1e9)[None].astype(jnp.float32)
    tcos, tsin = tds.ds_rope_tables(TC, S, "cpu")
    return (x.astype(np.float32), (cos, sin, mask),
            (tcos, tsin, tds._causal(S, "cpu")))


@pytest.mark.parametrize("moe", [False, True])
def test_fp_stats_match_jax(tiny, moe):
    x, jr, tr = _inputs()
    key = "moe_layers" if moe else "dense_layers"
    jo, js = jds.ds_layer(JC, None, "fp", _slice(tiny["jp"][key], 0), None,
                          jnp.asarray(x), *jr, moe=moe, with_stats=True)
    to, ts = tds.ds_layer(TC, None, "fp", tiny["tp"][key][0], None,
                          torch.from_numpy(x), *tr, moe, with_stats=True)
    assert sorted(ts) == sorted(js) == sorted(
        ["qkv", "wqb", "wo"] + (["moe_in", "moe_down"] if moe
                                else ["ffn_up", "ffn_down"]))
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   atol=1e-6, rtol=0, err_msg=k)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)


@pytest.mark.parametrize("moe", [False, True])
def test_calib_layer_and_gradients_match_jax(tiny, moe):
    x, jr, tr = _inputs()
    key = "moe_layers" if moe else "dense_layers"
    jstate = jds.init_ds_fq(JC, tiny["jfq"], seed=4)[int(moe)]
    jl, jf = _slice(tiny["jp"][key], 0), _slice(jstate, 0)
    w = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)

    def jloss(f):
        out = jds.ds_layer(JC, tiny["jfq"], "calib", jl, f, jnp.asarray(x),
                           *jr, moe=moe)
        return jnp.sum(out * w), out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jf)
    tf = tt._master(from_jax_ds_fq(
        _np(jds.init_ds_fq(JC, tiny["jfq"], seed=4)), "cpu")[int(moe)][0])
    labels = tds.build_ds_labels(tf)
    for t in tree_leaves(tf):
        t.requires_grad_(True)
    tout = tds.ds_layer(TC, tiny["fq"], "calib", tiny["tp"][key][0], tf,
                        torch.from_numpy(x), *tr, moe)
    (tout * torch.from_numpy(w)).sum().backward()
    jout = np.array(jout)
    scale = float(np.abs(jout).max())
    assert float((tout.detach() - torch.from_numpy(jout)).abs().max()) \
        <= 2e-4 * scale
    want = tree_leaves(from_jax_ds_fq(
        (jax.tree.map(lambda a: np.asarray(a)[None], jgrad), None),
        "cpu")[0][0])
    groups = {}
    for (t, lab), g in zip(tt.labeled_leaves(tf, labels), want):
        d, n = groups.get(lab, (0.0, 0.0))
        groups[lab] = (d + float(((t.grad - g) ** 2).sum()),
                       n + float((g ** 2).sum()))
    assert set(groups) == {"trans", "diag", "clip_w", "clip_a"}
    for lab, (d, n) in groups.items():
        assert (d / n) ** 0.5 <= 2e-3, (lab, (d / n) ** 0.5)


def test_sq_init_diag_matches_jax(tiny):
    rng = np.random.default_rng(7)
    jstate = jds.init_ds_fq(JC, tiny["jfq"], seed=2)
    tstate = from_jax_ds_fq(_np(jstate), "cpu")
    for moe, key in ((False, "dense_layers"), (True, "moe_layers")):
        x, jr, tr = _inputs(seed=int(moe))
        _, stats = jds.ds_layer(JC, None, "fp", _slice(tiny["jp"][key], 0),
                                None, jnp.asarray(x), *jr, moe=moe,
                                with_stats=True)
        stats = {k: np.asarray(v) * rng.uniform(0.5, 2) for k, v in
                 stats.items()}
        jout = jds.ds_sq_init_diag(JC, _slice(tiny["jp"][key], 0),
                                   _slice(jstate[int(moe)], 0),
                                   {k: jnp.asarray(v)
                                    for k, v in stats.items()}, 0.3)
        tout = tds.ds_sq_init_diag(TC, tiny["tp"][key][0],
                                   tstate[int(moe)][0],
                                   {k: torch.from_numpy(v)
                                    for k, v in stats.items()}, 0.3)
        want = from_jax_ds_fq(
            (jax.tree.map(lambda a: np.asarray(a)[None], jout), None),
            "cpu")[0][0]
        for part in ("attn", "ffn"):
            for k, t in tout[part].items():
                if k.endswith("_trans") and t is not None:
                    np.testing.assert_allclose(
                        t.diag_scale.numpy(), want[part][k].diag_scale.numpy(),
                        rtol=3e-7, err_msg=k)
        if moe:  # no statistic for the shared experts' down: init kept
            assert torch.equal(tout["ffn"]["w2_trans"].diag_scale,
                               tstate[1][0]["ffn"]["w2_trans"].diag_scale)


def test_bake_and_packing_match_jax(tiny):
    jstate = jds.init_ds_fq(JC, tiny["jfq"], seed=6)
    jbd, jbm = jax.jit(jds.bake_ds_fq)(*jstate)
    want_baked = from_jax_ds_fq(_np((jbd, jbm)), "cpu")
    got_baked = tds.bake_ds_fq(*from_jax_ds_fq(_np(jstate), "cpu"))
    for a, b in zip(tree_leaves(got_baked), tree_leaves(want_baked)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)
    # packing from the same frozen state
    jsp, _ = jax.jit(lambda p, d, m: jds.build_ds_serving_params(
        JC, tiny["jfq"], p, d, m))(tiny["jp"], jbd, jbm)
    tsp, tb = tds.build_ds_serving_params(TC, tiny["fq"], tiny["tp"],
                                          *want_baked)
    want = flatten_with_keys(from_jax_ds_serving_params(_np(jsp), "cpu"))
    got = flatten_with_keys(tsp)
    assert got.keys() == want.keys()
    flips = total = 0
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k.endswith("/wp"):
            d = unpack_weight_planar(g).int() - unpack_weight_planar(w).int()
            assert d.abs().max() <= 1, k
            flips += int((d != 0).sum())
            total += d.numel()
        elif k.endswith("/scale"):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                       err_msg=k)
        else:
            assert torch.equal(g, w), k
    assert flips <= 1e-3 * total, f"{flips} of {total} codes differ"
    # serve: the packed model's logits against JAX's (plain versions)
    toks = np.random.default_rng(0).integers(0, JC.vocab_size, (1, 12))
    jl = jax.jit(lambda p, f, t: jds.deepseek_forward(
        JC, p, t, fq=f, fq_cfg=tiny["jfq"], mode="serve",
        compute_dtype=jnp.float32))(jsp, (jbd, jbm), jnp.asarray(toks))
    tl = tds.deepseek_forward(TC, tsp, toks, fq=tb, fq_cfg=tiny["fq"],
                              mode="serve", compute_dtype=torch.float32,
                              device="cpu")
    cos = torch.nn.functional.cosine_similarity(
        tl.flatten(), torch.from_numpy(np.array(jl)).flatten(), dim=0)
    assert cos > 0.999, float(cos)


def test_calibrate_deepseek_tracks_jax(tiny):
    toks = get_loaders("synthetic", JC.vocab_size, nsamples=4, seqlen=16,
                       seed=0).train
    r = dict(RECIPE, epochs=2, nsamples=4)
    jlog, tlog = [], []
    jds.calibrate_deepseek(JC, JFQConfig(**r), tiny["jp"],
                           *jds.init_ds_fq(JC, JFQConfig(**r), seed=0), toks,
                           log=jlog.append)
    saved, hist = [], []
    got = tds.calibrate_deepseek(
        TC, FQConfig(**r), tiny["tp"],
        *tds.init_ds_fq(TC, FQConfig(**r), seed=0, device="cpu"), toks,
        log=tlog.append, save_cb=lambda i, st: saved.append(i),
        history=hist)

    def mse(lines):
        return {(m[1], int(m[2]), int(m[3])): float(m[4]) for m in (
            re.match(r"(dense|moe) layer (\d+) epoch (\d+) mse ([\d.e+-]+)",
                     s) for s in lines) if m}

    jm, tm = mse(jlog), mse(tlog)
    assert jm.keys() == tm.keys() and len(tm) == 2 * TC.n_layers
    for k in jm:
        assert abs(tm[k] - jm[k]) <= 0.15 * jm[k], (k, jm, tm)
    assert saved == list(range(TC.n_moe_layers)) and len(hist) == TC.n_layers
    assert all(not t.requires_grad for t in tree_leaves(got))
