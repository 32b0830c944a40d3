"""The port's GPTQ (flatquant_torch/calib/gptq.py) and perplexity
(flatquant_torch/evals/ppl.py) against the JAX package's, on the CPU.

Inputs: seeded correlated Hessians (numpy), and `tiny-llama` from JAX's
init_params and init_model_fq (converted with utils/convert.py).

Tolerances, and why:
  - gptq_quantize_weight: the integer codes (each value over its row's
    max-abs code step) equal JAX's on every case here (the share of codes
    that differ is 0, asserted at most 1e-3: a code may flip where the
    two loops' float32 error feedback straddles a rounding tie); values
    within 1e-5 relative of the weight's scale (JAX's jitted loop divides
    by q_max as a reciprocal multiplication, so its scales sit one ulp
    off the port's IEEE division); the reconstruction error ||X (Q -
    W)^T|| within 1% of JAX's.
  - gptq_model on tiny-llama: every quantized weight within 1e-3 of
    JAX's in units of its own code step, the share of flipped codes at
    most 1e-3; layer inputs propagate through the quantized layer in
    both.
  - ppl_eval: "fp" within 1e-5 relative; "eval" (fake-quant, from JAX's
    baked weights) within 1e-4 relative (float32 sums in another order
    round an activation-quant code apart now and then).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flatquant_tpu.calib import gptq as jg
from flatquant_tpu.calib.data import get_loaders
from flatquant_tpu.core.quant import WeightQuantCfg as JWCfg
from flatquant_tpu.evals.ppl import ppl_eval as j_ppl_eval
from flatquant_tpu.models.config import get_config as j_get_config
from flatquant_tpu.models.llama import init_params as j_init_params
from flatquant_tpu.quantize import bake as jbake
from flatquant_tpu.quantize.spec import FQConfig as JFQConfig
from flatquant_tpu.quantize.state import init_model_fq as j_init_model_fq
from flatquant_torch.calib import gptq as tg
from flatquant_torch.core.quant import WeightQuantCfg
from flatquant_torch.evals.ppl import ppl_eval
from flatquant_torch.models.config import get_config
from flatquant_torch.quantize.spec import FQConfig
from flatquant_torch.utils.convert import from_jax_fq, from_jax_params

torch.set_num_threads(2)

RECIPE = dict(w_bits=4, a_bits=4, k_bits=4, v_bits=4, k_asym=True,
              v_asym=True, lac=True, lwc=True, gptq=True)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _hessian(rng, n, tokens=512):
    x = rng.normal(size=(tokens, n)).astype(np.float32)
    x = x @ (rng.normal(size=(n, n)).astype(np.float32) * 0.3)
    x[:, 3] = 0.0  # a dead column
    return x, (2.0 * x.T @ x).astype(np.float32)


def _step(q, group):
    """Each weight's code step: the row's (or group's) max |value| / 7."""
    rows = np.abs(q).reshape(q.shape[0], -1, group if group > 0
                             else q.shape[1])
    return np.repeat(rows.max(-1, keepdims=True), rows.shape[-1],
                     -1).reshape(q.shape) / 7.0 + 1e-12


@pytest.mark.parametrize("out,n,group,sym,act_order", [
    (64, 256, -1, True, False),   # blocked, per channel
    (64, 256, 64, True, True),    # blocked, groups of 64, act_order
    (48, 96, -1, False, False),   # per-column loop (96 % 128), asym
    (48, 96, 32, True, True),     # per-column loop with groups
])
def test_gptq_quantize_weight_matches_jax(out, n, group, sym, act_order):
    rng = np.random.default_rng(n + out)
    w = rng.normal(size=(out, n)).astype(np.float32)
    x, h = _hessian(rng, n)
    qj = np.asarray(jg.gptq_quantize_weight(
        w, h, JWCfg(bits=4, sym=sym, group_size=group), act_order=act_order))
    qt = tg.gptq_quantize_weight(
        torch.from_numpy(w), torch.from_numpy(h),
        WeightQuantCfg(bits=4, sym=sym, group_size=group),
        act_order=act_order).numpy()
    assert (qt[:, 3] == 0).all() and (qj[:, 3] == 0).all()
    rel = np.abs(qt - qj) / _step(qj, group)
    flips = float((rel > 0.5).mean())
    assert flips <= 1e-3, f"share of codes that differ: {flips}"
    assert rel[rel <= 0.5].max() <= 1e-5
    ej = np.linalg.norm(x @ (qj - w).T)
    et = np.linalg.norm(x @ (qt - w).T)
    assert abs(et - ej) <= 0.01 * ej


def test_hessian_inverse_factor_is_upper_cholesky_of_inverse():
    _, h = _hessian(np.random.default_rng(0), 64)
    h[np.arange(64), np.arange(64)] += 1.0
    u = tg.hessian_inverse_factor(torch.from_numpy(h)).double().numpy()
    assert np.allclose(np.tril(u, -1), 0.0)
    np.testing.assert_allclose(u.T @ u, np.linalg.inv(h.astype(np.float64)),
                               rtol=1e-3, atol=1e-6)


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_get_config("tiny-llama")
    jfq = JFQConfig(**RECIPE)
    jp = j_init_params(jcfg, seed=0)
    jstate = j_init_model_fq(jcfg, jfq, seed=0)
    jbp, jbf = jbake.bake_model(jcfg, jfq, jp, jstate)
    toks = get_loaders("synthetic", jcfg.vocab_size, nsamples=4, seqlen=32,
                       seed=0)
    return dict(jcfg=jcfg, jfq=jfq, jp=jp, jbp=jbp, jbf=jbf, data=toks,
                cfg=get_config("tiny-llama"), fq=FQConfig(**RECIPE),
                tp=from_jax_params(_np(jp), "cpu"),
                tbp=from_jax_params(_np(jbp), "cpu"),
                tbf=from_jax_fq(_np(jbf), "cpu"))


def test_gptq_model_matches_jax(tiny):
    """From JAX's baked model (the same frozen transforms and clips)."""
    want = from_jax_params(_np(jg.gptq_model(
        tiny["jcfg"], tiny["jfq"], tiny["jbp"], tiny["jbf"],
        tiny["data"].train, log=lambda s: None)), "cpu")
    hist = []
    got = tg.gptq_model(tiny["cfg"], tiny["fq"], tiny["tbp"], tiny["tbf"],
                        tiny["data"].train, log=lambda s: None, history=hist)
    assert [h["layer"] for h in hist] == [0, 1]
    flips = total = 0
    for g, w, b in zip(got["layers"], want["layers"], tiny["tbp"]["layers"]):
        for key in ("wq", "wk", "wv", "wo", "wup", "wgate", "wdown"):
            wn = w[key].numpy()
            assert not np.array_equal(wn, b[key].numpy()), key
            rel = np.abs(g[key].numpy() - wn) / _step(wn, -1)
            flips += int((rel > 0.5).sum())
            total += rel.size
            assert rel[rel <= 0.5].max() <= 1e-3, key
    assert flips <= 1e-3 * total, f"{flips} of {total} codes differ"
    # the caller's params are not changed
    assert torch.equal(tiny["tbp"]["layers"][0]["wq"],
                       from_jax_params(_np(tiny["jbp"]),
                                       "cpu")["layers"][0]["wq"])


@pytest.mark.parametrize("mode", ["fp", "eval"])
def test_ppl_matches_jax(tiny, mode):
    test = tiny["data"].test[:, :32 * 40]
    if mode == "fp":
        jargs, targs = (tiny["jp"], None), (tiny["tp"], None)
    else:
        jev = jbake.rtn_quantize_params(tiny["jfq"], tiny["jbp"])
        jargs = (jev, tiny["jbf"])
        targs = (from_jax_params(_np(jev), "cpu"), tiny["tbf"])
    want = j_ppl_eval(tiny["jcfg"], jargs[0], test, fq=jargs[1],
                      fq_cfg=tiny["jfq"], mode=mode, seqlen=32,
                      compute_dtype=jnp.float32)
    got = ppl_eval(tiny["cfg"], targs[0], test, fq=targs[1],
                   fq_cfg=tiny["fq"], mode=mode, seqlen=32,
                   compute_dtype=torch.float32)
    assert abs(got - want) <= (1e-5 if mode == "fp" else 1e-4) * want
