"""The port's fake-quant math and calibration forward against the JAX
package, on the CPU.

Inputs are made with numpy from seeds and go through both packages:
core/ste.py, core/packing.py, core/quant.py (activation and weight
quantizers over sym / asym, per token / per group, per channel / per
tensor / groups, LAC and static clip ratios, the MSE shrink search) and
one `tiny-llama` decoder layer in "calib" mode under torch.autograd
against jax.grad.

Tolerances, and why:
  - the quantizers: bit for bit. Both divide by IEEE division (the port
    through core/quant.py true_div), round half to even and clip
    through maximum then minimum. Where the MSE search keeps another
    shrink step (its float32 error sums run in another order, and the
    pow of torch and of XLA may differ by an ulp), the test shows the two
    steps' errors tie within 1e-6 relative (JAX's jitted search loop also
    divides by q_max as a reciprocal multiplication, one ulp off).
  - sigmoid: JAX's logistic is 1 / (1 + exp(-x)) with XLA's exp;
    torch.sigmoid is within 2 float32 ulps of it and equal at every LAC
    value these tests use, the init 4.0 among them (spelling out JAX's
    formula with torch.exp would be further off: torch's and XLA's exp
    differ on ~4% of inputs).
  - calib gradients: each group of leaves (the Kronecker and single
    factors, the diag scales, the clip factors) within 1e-4 of JAX's by
    relative norm; the loss within 1e-5 relative. Both forwards are
    float32 with the same STE and tie rules; the float32 Cayley solves
    and sums run in other orders.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flatquant_tpu.core import packing as jpk
from flatquant_tpu.core import quant as jq
from flatquant_tpu.core import ste as jste
from flatquant_tpu.models import llama as jl
from flatquant_tpu.models.config import get_config as j_get_config
from flatquant_tpu.quantize import linear as jlin
from flatquant_tpu.quantize.spec import W4A4KV4 as J_W4A4KV4
from flatquant_tpu.quantize.state import init_model_fq as j_init_model_fq
from flatquant_tpu.quantize.state import slice_layer
from flatquant_torch.core import packing as tpk
from flatquant_torch.core import quant as tq
from flatquant_torch.core import ste as tste
from flatquant_torch.models import llama as tl
from flatquant_torch.models.config import get_config
from flatquant_torch.quantize import linear as tlin
from flatquant_torch.quantize.spec import W4A4KV4
from flatquant_torch.utils.convert import from_jax_fq

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want, what=""):
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want),
                                  err_msg=what)


# ---------------------------------------------------------------------------
# STE, packing, grids
# ---------------------------------------------------------------------------


def test_round_and_clamp_ste_match_jax():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49, -3.7, 9.2],
                 np.float32)
    xt = _t(x).requires_grad_(True)
    y = tste.round_ste(xt)
    _eq(y, jste.round_ste(jnp.asarray(x)))
    y.sum().backward()
    _eq(xt.grad, jax.grad(lambda a: jste.round_ste(a).sum())(jnp.asarray(x)))
    xt.grad = None
    c = tste.clamp_ste(xt, -1.0, 2.0)
    _eq(c, jste.clamp_ste(jnp.asarray(x), -1.0, 2.0))
    c.sum().backward()
    assert (xt.grad == 1).all()


def test_pack_unpack_int4_match_jax():
    q = np.tile(np.arange(-8, 8, dtype=np.int8), 12).reshape(6, 32)
    packed = tpk.pack_int4(_t(q))
    _eq(packed, jpk.pack_int4(jnp.asarray(q)))
    _eq(tpk.unpack_int4(packed), q)
    b = np.arange(256, dtype=np.uint8).reshape(4, 64)
    _eq(tpk.unpack_int4(_t(b)), jpk.unpack_int4(jnp.asarray(b)))


@pytest.mark.parametrize("bits,sym", [(4, True), (4, False), (8, True),
                                      (3, False)])
def test_qmin_qmax_match_jax(bits, sym):
    assert tq.get_qmin_qmax(bits, sym) == jq.get_qmin_qmax(bits, sym)


def test_sigmoid_within_two_ulps_of_jax():
    x = np.random.default_rng(0).normal(size=200_000).astype(np.float32) * 6
    want = np.asarray(jax.nn.sigmoid(jnp.asarray(x)))
    got = torch.sigmoid(_t(x)).numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32))
    assert ulps.max() <= 2 and (ulps > 0).mean() < 0.01
    lac = np.array([4.0, 2.5, 3.0, 1.0, 0.5, -1.0, 3.5], np.float32)
    _eq(torch.sigmoid(_t(lac)), jax.nn.sigmoid(jnp.asarray(lac)))


# ---------------------------------------------------------------------------
# activation quantizer
# ---------------------------------------------------------------------------


def _acts(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 7, 64)).astype(np.float32)
    x[0, 1] *= 40.0  # an outlier token
    x[1, 2] = 0.0  # a degenerate token
    x[2, 3] = np.abs(x[2, 3])  # all >= 0
    x[2, 4] = -np.abs(x[2, 4])  # all <= 0
    x[0, 5, :16] = 0.0  # a degenerate group
    return x.astype(dtype)


ACT_CASES = {
    "a4-sym": dict(bits=4),
    "a4-sym-lac": dict(bits=4, lac=True),
    "a4-asym-lac": dict(bits=4, sym=False, lac=True),
    "a4-asym-g16": dict(bits=4, sym=False, group_size=16),
    "a4-sym-g32-lac": dict(bits=4, group_size=32, lac=True),
    "a8-sym-ratio": dict(bits=8, clip_ratio=0.9),
    "a4-asym-ratio": dict(bits=4, sym=False, clip_ratio=0.85),
    "a16": dict(bits=16),
}


@pytest.mark.parametrize("case", list(ACT_CASES))
@pytest.mark.parametrize("clips", [(4.0, 4.0), (2.5, 1.0)])
def test_act_fake_quant_matches_jax(case, clips):
    kw = ACT_CASES[case]
    x = _acts(1)
    jcfg, tcfg = jq.ActQuantCfg(**kw), tq.ActQuantCfg(**kw)
    cmax, cmin = (np.array([c], np.float32) for c in clips)
    jc = (jnp.asarray(cmax), jnp.asarray(cmin))
    tc = (_t(cmax), _t(cmin))
    _eq(tq.act_fake_quant(_t(x), tcfg, *tc),
        jq.act_fake_quant(jnp.asarray(x), jcfg, *jc), case)
    if tcfg.enabled:
        for got, want in zip(tq.act_scale_zero(_t(x), tcfg, *tc),
                             jq.act_scale_zero(jnp.asarray(x), jcfg, *jc)):
            _eq(got, want, case)
    assert torch.equal(tq.act_fake_quant(_t(x), tcfg, *tc, enabled=False),
                       _t(x))


def test_act_fake_quant_bf16_matches_jax():
    x = _acts(2)
    cfg = dict(bits=4, lac=True)
    c = np.array([3.0], np.float32)
    got = tq.act_fake_quant(_t(x).to(torch.bfloat16), tq.ActQuantCfg(**cfg),
                            _t(c), _t(c))
    want = jq.act_fake_quant(jnp.asarray(x, jnp.bfloat16),
                             jq.ActQuantCfg(**cfg), jnp.asarray(c),
                             jnp.asarray(c))
    assert got.dtype == torch.bfloat16
    _eq(got.float(), np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# weight quantizer
# ---------------------------------------------------------------------------


W_CASES = {
    "w4-sym": dict(bits=4),
    "w4-asym": dict(bits=4, sym=False),
    "w4-sym-tensor": dict(bits=4, perchannel=False),
    "w4-asym-tensor": dict(bits=4, sym=False, perchannel=False),
    "w4-sym-g32": dict(bits=4, group_size=32),
    "w4-asym-g16": dict(bits=4, sym=False, group_size=16),
    "w8-sym": dict(bits=8),
    "w4-sym-mse": dict(bits=4, mse=True),
    "w4-asym-mse": dict(bits=4, sym=False, mse=True),
    "w3-asym-g16-mse": dict(bits=3, sym=False, group_size=16, mse=True),
}


def _weight(seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(48, 64)).astype(np.float32) * 0.05
    w[3] = 0.0  # a degenerate row
    w[5, 7] = 1.5  # an outlier
    w[9] = np.abs(w[9])
    return w


def _mse_err(rows, scale, zero, cfg):
    """float64 Lp error of one row quantized with (scale, zero)."""
    r = rows.astype(np.float64)
    s, z = np.float64(scale), np.float64(zero)
    if cfg.sym:
        q = np.clip(np.round(r / s), -(cfg.q_max + 1), cfg.q_max) * s
    else:
        q = (np.clip(np.round(r / s) + z, 0, cfg.q_max) - z) * s
    return np.sum(np.abs(q - r) ** cfg.norm)


@pytest.mark.parametrize("case", list(W_CASES))
def test_weight_quant_matches_jax(case):
    kw = W_CASES[case]
    w = _weight(3)
    jcfg, tcfg = jq.WeightQuantCfg(**kw), tq.WeightQuantCfg(**kw)
    js, jz = (np.asarray(a) for a in jq.weight_find_params(jnp.asarray(w),
                                                           jcfg))
    ts, tz = (a.numpy() for a in tq.weight_find_params(_t(w), tcfg))
    assert ts.shape == js.shape and tz.shape == jz.shape
    differ = (ts != js) | (tz != jz)
    if not tcfg.mse:
        assert not differ.any(), case
    else:
        # JAX's search loop is jitted, and XLA divides by the constant
        # q_max as a multiplication by its reciprocal (one float32 ulp off
        # the port's division): a row's scales may differ, only where the
        # two choices' errors tie
        rows = np.asarray(jq._weight_rows(jnp.asarray(w), jcfg))
        for r in np.flatnonzero(differ[:, 0]):
            e_t = _mse_err(rows[r], ts[r, 0], tz[r, 0], tcfg)
            e_j = _mse_err(rows[r], js[r, 0], jz[r, 0], jcfg)
            assert abs(e_t - e_j) <= 1e-6 * max(e_j, 1e-30), (case, r)
    # codes and fake-quant values from the same (JAX's) params
    _eq(tq.weight_quantize_int(_t(w), _t(js), _t(jz), tcfg),
        jq.weight_quantize_int(jnp.asarray(w), js, jz, jcfg), case)
    _eq(tq.weight_fake_quant(_t(w), _t(js), _t(jz), tcfg),
        jq.weight_fake_quant(jnp.asarray(w), js, jz, jcfg), case)


@pytest.mark.parametrize("lwc", [False, True])
def test_bake_linear_weight_matches_jax(lwc):
    """transform_weight (the o_proj pair form, learnable weight clipping)
    within 1e-6 relative of JAX's (float32 Kronecker products summed in
    another order), and bake_linear_weight's RTN on JAX's transformed
    weight bit for bit."""
    rng = np.random.default_rng(4)
    w = rng.normal(size=(32, 64)).astype(np.float32) * 0.05
    left = np.linalg.qr(rng.normal(size=(4, 4)))[0].astype(np.float32)
    right = np.linalg.qr(rng.normal(size=(16, 16)))[0].astype(np.float32)
    clip = rng.normal(size=(32, 1)).astype(np.float32) + 3.0
    jcfg, tcfg = jq.WeightQuantCfg(bits=4), tq.WeightQuantCfg(bits=4)
    jst = jlin.LinearQuantState(jnp.asarray(clip), jnp.asarray(clip - 0.5),
                                None, None)
    tst = tlin.LinearQuantState(_t(clip), _t(clip - 0.5), None, None)
    want = np.asarray(jlin.transform_weight(
        jnp.asarray(w), jst, (jnp.asarray(left), jnp.asarray(right)),
        lwc=lwc))
    got = tlin.transform_weight(_t(w), tst, (_t(left), _t(right)), lwc=lwc)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    _eq(tlin.bake_linear_weight(_t(want), tst, tcfg),
        jlin.bake_linear_weight(jnp.asarray(want), jst, jcfg))


# ---------------------------------------------------------------------------
# one calib-mode layer: loss and gradients
# ---------------------------------------------------------------------------


def _leaves(tree, out):
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            _leaves(getattr(tree, f.name), out)
    elif torch.is_tensor(tree):
        out.append(tree)
    return out


def _groups(jfq):
    """The gradient group of each leaf of a JAX LayerFQ, in tree order:
    factors (u, v, d, m), diag scales, clip factors."""
    paths = jax.tree_util.tree_flatten_with_path(jfq)[0]
    out = []
    for path, _ in paths:
        name = jax.tree_util.keystr(path)
        out.append("clips" if "clip" in name else
                   "diag" if "diag_scale" in name else "factors")
    return out


def test_calib_layer_loss_and_grads_match_jax():
    jcfg, cfg = j_get_config("tiny-llama"), get_config("tiny-llama")
    jfq_cfg, fq_cfg = J_W4A4KV4, W4A4KV4
    S = 16
    rng = np.random.default_rng(3)
    # perturbed state: generic clips, diags and factors (the init's clips
    # all sit at 4.0)
    state = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + rng.normal(
            size=np.shape(a)).astype(np.float32) * 0.3),
        slice_layer(j_init_model_fq(jcfg, jfq_cfg, seed=0), 0))
    lp = {k: v[0] for k, v in jl.init_params(jcfg, seed=0)["layers"].items()}
    x = rng.normal(size=(2, S, cfg.hidden_size)).astype(np.float32)
    tgt = rng.normal(size=(2, S, cfg.hidden_size)).astype(np.float32)
    cos, sin = jl.rope_tables(jcfg, jnp.arange(S))
    mask = jl.causal_mask(S)

    def jloss(st):
        y = jl.llama_layer(jcfg, jfq_cfg, "calib", lp, st, jnp.asarray(x),
                           cos, sin, mask)
        return jnp.mean((y - tgt) ** 2)

    jval, jgrad = jax.jit(jax.value_and_grad(jloss))(state)
    tstate = from_jax_fq(jax.tree.map(lambda a: np.asarray(a)[None], state),
                         "cpu")[0]
    leaves = [t.requires_grad_(True) for t in _leaves(tstate, [])]
    tcos, tsin = tl.rope_tables(cfg, torch.arange(S))
    y = tl.llama_layer(cfg, fq_cfg, "calib",
                       {k: _t(v) for k, v in lp.items()}, tstate, _t(x),
                       tcos, tsin, tl.causal_mask(S, "cpu"))
    loss = torch.mean((y - _t(tgt)) ** 2)
    loss.backward()
    assert abs(loss.item() - float(jval)) <= 1e-5 * float(jval)
    jleaves = jax.tree.leaves(jgrad)
    groups = _groups(jgrad)
    assert len(jleaves) == len(leaves) == len(groups)
    for g in ("factors", "diag", "clips"):
        pairs = [(np.asarray(j).ravel(), t.grad.numpy().ravel())
                 for j, t, gg in zip(jleaves, leaves, groups) if gg == g]
        want = np.concatenate([p[0] for p in pairs])
        got = np.concatenate([p[1] for p in pairs])
        assert np.linalg.norm(want) > 0, g
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 1e-4, (g, rel)
