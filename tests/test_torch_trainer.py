"""The port's calibration trainer (flatquant_torch/calib/trainer.py)
against the JAX package's, on the CPU.

Inputs: `tiny-llama` weights from JAX's init_params (converted with
utils/convert.py), init_model_fq from the same seed in both packages (bit
for bit), tokens from get_loaders' synthetic corpus (bit for bit).

Tolerances, and why:
  - the learning rate at every step: within 4 float32 ulps of optax's
    jitted schedule, with and without warmup (the port evaluates the
    cosine in float64 and rounds once; XLA folds pi / total and
    0.5 * (1 - alpha) into constants and takes its own float32 cosine,
    which is off the correctly rounded value on ~1% of inputs). Whole
    AdamW runs from the same gradients: every group within 3e-6 relative
    (1e-6 absolute) of optax's parameters after 20 steps, a few float32
    ulps of rounding (torch takes the rate as a Python float, optax as a
    float32, and they order the bias corrections differently; measured
    1.4e-6); frozen groups unchanged.
  - sq_init_diag from the same statistics: within 2 float32 ulps
    (torch's and XLA's pow round apart at times).
  - one step (float32, deactive_amp, one_style diag): the batch MSE
    before the update within 2e-4 relative, at least 85% of coordinates
    take the identical step (within 2% of the leaf's step), at most 1%
    one of another size: the bands tests/test_trainer_parity.py holds
    JAX to against the reference torch trainer. AdamW's first step is
    lr * sign(g), so a float32 ulp of difference in a near-zero
    gradient flips a coordinate's whole step.
  - a 2-epoch trajectory: every (layer, epoch) MSE within 15%.
"""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from flatquant_tpu.calib import trainer as jt
from flatquant_tpu.calib.data import get_loaders as j_get_loaders
from flatquant_tpu.models.config import get_config as j_get_config
from flatquant_tpu.models.llama import init_params as j_init_params
from flatquant_tpu.quantize.spec import FQConfig as JFQConfig
from flatquant_tpu.quantize.state import init_model_fq as j_init_model_fq
from flatquant_tpu.quantize.state import slice_layer
from flatquant_torch.calib import trainer as tt
from flatquant_torch.calib.data import get_loaders
from flatquant_torch.models.config import get_config
from flatquant_torch.quantize.spec import FQConfig
from flatquant_torch.quantize.state import init_model_fq
from flatquant_torch.utils.convert import from_jax_fq, from_jax_params
from flatquant_torch.utils.tree import tree_leaves

torch.set_num_threads(2)

RECIPE = dict(w_bits=4, a_bits=4, k_bits=4, v_bits=4, k_asym=True,
              v_asym=True, cali_trans=True, add_diag=True, lwc=True,
              lac=True, deactive_amp=True, cali_bsz=4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warmup", [False, True])
def test_schedule_matches_optax(warmup):
    """lr_at(k) against the schedule JAX's make_optimizer builds, jitted
    as in its train step, for the trans and the clip groups."""
    worst, exact, n = 0, 0, 0
    for flat_lr in (5e-3, 1e-3):
        fq = FQConfig(flat_lr=flat_lr, warmup=warmup)
        for total in (1, 7, 32, 100, 480):
            for group in ("trans", "clip_a"):
                base = tt.group_base_lr(fq, group)
                cos = optax.cosine_decay_schedule(
                    base, total, alpha=flat_lr * 1e-3 / base)
                if warmup:
                    sched = jax.jit(lambda s, c=cos: c(s) * (
                        0.01 + 0.99 * jnp.minimum(s.astype(jnp.float32),
                                                  16.0) / 16.0))
                else:
                    sched = jax.jit(cos)
                for k in range(total + 2):
                    want = np.float32(sched(jnp.int32(k)))
                    got = np.float32(tt.lr_at(fq, base, total, k))
                    u = int(_ulps(got, want))
                    worst, exact, n = max(worst, u), exact + (u == 0), n + 1
    assert worst <= 4, f"{worst} ulps; {exact} of {n} exact"


def _toy_state(seed):
    """One tiny-llama LayerFQ in both packages (bit for bit)."""
    fq = FQConfig(**RECIPE)
    jcfg = j_get_config("tiny-llama")
    jst = slice_layer(j_init_model_fq(jcfg, JFQConfig(**RECIPE), seed=seed),
                      0)
    tst = init_model_fq(get_config("tiny-llama"), fq, seed=seed,
                        device="cpu")[0]
    return fq, jst, tst


@pytest.mark.parametrize("flags", [
    dict(warmup=True),
    dict(cali_trans=False, lac=False),
], ids=["all_groups_warmup", "trans_and_clip_a_frozen"])
def test_adamw_matches_optax(flags):
    """20 updates from the same seeded gradients: the port's GroupAdamW
    lands on optax's multi_transform parameters; a disabled group stays
    where it started."""
    _, jst, tst = _toy_state(1)
    recipe = dict(RECIPE, **flags)
    fq, jfq = FQConfig(**recipe), JFQConfig(**recipe)
    total = 20
    labels = jt.build_labels(jst)
    tx = jt.make_optimizer(jfq, labels, total)
    opt_state = tx.init(jst)
    update = jax.jit(tx.update)
    state = tt._master(tst)
    start = [t.clone() for t in tree_leaves(state)]
    opt = tt.make_optimizer(fq, state, tt.build_labels(state), total)
    rng = np.random.default_rng(2)
    for _ in range(total):
        grads = jax.tree.map(
            lambda a: jnp.asarray(rng.normal(size=a.shape).astype(a.dtype)),
            jst)
        updates, opt_state = update(grads, opt_state, jst)
        jst = optax.apply_updates(jst, updates)
        for t, g in zip(tree_leaves(state), tree_leaves(from_jax_fq(
                jax.tree.map(lambda a: np.asarray(a)[None], grads),
                "cpu")[0])):
            t.grad = g.clone() if t.requires_grad else None
        opt.step()
    on = tt.group_enabled(fq)
    want = tree_leaves(from_jax_fq(jax.tree.map(
        lambda a: np.asarray(a)[None], jst), "cpu")[0])
    leaves = tt.labeled_leaves(state, tt.build_labels(state))
    for (t, lab), w, s in zip(leaves, want, start):
        np.testing.assert_allclose(t.detach().numpy(), w.numpy(), rtol=3e-6,
                                   atol=1e-6, err_msg=lab)
        if not on[lab]:
            assert torch.equal(t.detach(), s), lab
            assert not t.requires_grad, lab


def test_sq_init_diag_matches_jax():
    fq, jst, tst = _toy_state(3)
    rng = np.random.default_rng(4)
    cfg = get_config("tiny-llama")
    H, I = cfg.hidden_size, cfg.intermediate_size
    lp = {k: rng.normal(size=s).astype(np.float32) * 0.05
          for k, s in (("wq", (cfg.q_dim, H)), ("wk", (cfg.kv_dim, H)),
                       ("wv", (cfg.kv_dim, H)), ("wup", (I, H)),
                       ("wgate", (I, H)), ("wdown", (H, I)))}
    stats = {k: np.abs(rng.normal(size=n)).astype(np.float32) * 3
             for k, n in (("ln", H), ("up", H), ("down", I))}
    stats["ln"][:5] = 0.0  # below the 1e-5 floor
    jout = jt.sq_init_diag({k: jnp.asarray(v) for k, v in lp.items()}, jst,
                           {k: jnp.asarray(v) for k, v in stats.items()}, 0.3)
    tout = tt.sq_init_diag({k: torch.from_numpy(v) for k, v in lp.items()},
                           tst, {k: torch.from_numpy(v)
                                 for k, v in stats.items()}, 0.3)
    for jt_, tt_ in ((jout.attn.ln_trans, tout.attn.ln_trans),
                     (jout.mlp.up_gate_trans, tout.mlp.up_gate_trans),
                     (jout.mlp.down_trans, tout.mlp.down_trans)):
        assert _ulps(tt_.diag_scale.numpy(), jt_.diag_scale).max() <= 2


# ---------------------------------------------------------------------------
# the calibration loop on tiny-llama
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_get_config("tiny-llama")
    jp = j_init_params(jcfg, seed=0)
    toks = j_get_loaders("synthetic", jcfg.vocab_size, nsamples=8,
                         seqlen=32, seed=0).train
    ttoks = get_loaders("synthetic", jcfg.vocab_size, nsamples=8, seqlen=32,
                        seed=0).train
    np.testing.assert_array_equal(toks, ttoks)
    return dict(jcfg=jcfg, jp=jp, cfg=get_config("tiny-llama"),
                tp=from_jax_params(_np(jp), "cpu"), toks=toks)


def _run_both(tiny, **over):
    recipe = dict(RECIPE, **over)
    fq, jfq = FQConfig(**recipe), JFQConfig(**recipe)
    n = recipe["nsamples"]
    jlog, tlog = [], []
    jout = jt.calibrate(tiny["jcfg"], jfq, tiny["jp"],
                        j_init_model_fq(tiny["jcfg"], jfq, seed=0),
                        tiny["toks"][:n], log=jlog.append)
    start = init_model_fq(tiny["cfg"], fq, seed=0, device="cpu")
    tout = tt.calibrate(tiny["cfg"], fq, tiny["tp"], start,
                        tiny["toks"][:n], log=tlog.append)

    def mse(lines):
        return {(int(m[1]), int(m[2])): float(m[3]) for m in (
            re.match(r"layer (\d+) epoch (\d+) mse ([\d.e+-]+)", s)
            for s in lines) if m}

    return mse(jlog), mse(tlog), start, jout, tout


def test_one_step_tracks_jax(tiny):
    jm, tm, start, jout, tout = _run_both(tiny, nsamples=4, epochs=1,
                                          diag_init="one_style")
    assert jm.keys() == tm.keys() and len(tm) == 2
    for key in jm:
        assert abs(tm[key] - jm[key]) <= 2e-4 * jm[key], (key, jm, tm)
    want = from_jax_fq(_np(jout), "cpu")
    flipped = between = total = 0
    for s, w, g in zip(start, want, tout):
        for a0, a1, b1 in zip(tree_leaves(s), tree_leaves(w),
                              tree_leaves(g)):
            step = float((a1 - a0).abs().max()) + 1e-12
            err = (b1 - a1).abs()
            flipped += int((err > 0.5 * step).sum())
            between += int(((err > 0.02 * step) & (err <= 0.5 * step)).sum())
            total += err.numel()
    assert flipped <= 0.15 * total, f"{flipped} of {total} flipped"
    assert between <= 0.01 * total, f"{between} of {total} off-size"


def test_two_epoch_trajectory_tracks_jax(tiny):
    jm, tm, _, _, _ = _run_both(tiny, nsamples=8, epochs=2)
    assert jm.keys() == tm.keys() and len(tm) == 4
    for key in jm:
        assert abs(tm[key] - jm[key]) <= 0.15 * jm[key], (key, jm, tm)


def test_history_records_every_step(tiny):
    fq = FQConfig(**dict(RECIPE, nsamples=8, epochs=2))
    hist = []
    tt.calibrate(tiny["cfg"], fq, tiny["tp"],
                 init_model_fq(tiny["cfg"], fq, seed=0, device="cpu"),
                 tiny["toks"], log=lambda s: None, history=hist)
    assert [h["layer"] for h in hist] == [0, 1]
    for h in hist:
        assert len(h["step_mse"]) == 4 and len(h["epoch_mse"]) == 2
        assert np.isfinite(h["step_mse"]).all() and h["teacher_s"] >= 0
        assert np.isclose(sum(h["step_mse"][:2]), h["epoch_mse"][0])
