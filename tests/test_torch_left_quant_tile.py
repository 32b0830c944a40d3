"""Rows 5 and 23's device body (`left_quant_i8_flat` and
`left_quant_i8_grouped`, kernels/flat_pipeline.py and grouped_mlp.py,
csrc/flat_pipeline.cu), on the CPU: the padding of wgmma's tile and the
two layouts' tensor maps.

The body stages left_t as wgmma's A, zero-padded to M = 64 * MT rows and
K = KP columns (G rounded up to 16), and each token's slab X_t [G, 128]
as B, KP rows of which those past G land as zeros (TMA's fill outside
the tensor). A torch emulation of that product, with the extrema taken
over the real rows only, must equal the plain version with identity
factors (every z one exact product) and stay within the JAX package's
bounds of JAX's `left_quant_i8_flat` / `left_quant_i8_grouped` (their
Pallas kernels in interpret mode) with random orthogonal ones: scales
within 1e-6, codes within 1 on under 1% (tests/test_torch_prefill.py).
The two kernels read and write through [T][G][128] views whose strides
alone differ, so their outputs on the same values are the same bytes.

The CUDA body itself is held to the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py (phases 3d, 3j, 5, 6 and 12).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from flatquant_tpu.kernels import flat_pipeline as jfp
from flatquant_tpu.kernels import grouped_mlp as jgm
from flatquant_torch.kernels import flat_pipeline as tfp
from flatquant_torch.kernels import grouped_mlp as tgm
from flatquant_torch.kernels.int4_matmul import quant_acts_i8_ref

torch.set_num_threads(2)


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _tile(g):
    """The body's padded sizes: (MT, KP) (csrc lq_kpad, mt)."""
    return (2 if g > 64 else 1), (g + 15) // 16 * 16


def _token_view(flat, t, g, grouped):
    """The tensor maps' [T][G][128] view of a flat [T * G * 128] buffer:
    token-major (left_quant_i8_flat) or group-major (_grouped)."""
    strides = (128, t * 128, 1) if grouped else (g * 128, 128, 1)
    return flat.as_strided((t, g, 128), strides)


def _emulate_body(left_t, x_flat, t, g, clip, q_max, grouped):
    """The wgmma body on a flat buffer in either layout: per token, Z =
    A_pad @ X_pad in float32 (A: left_t in bf16 zero-padded to [64 MT,
    KP]; X: the slab, rows past G zero), z in bf16, extrema over rows < G,
    the scale, codes written through the same view."""
    mt, kp = _tile(g)
    a = torch.zeros((64 * mt, kp))
    a[:g, :g] = left_t.to(torch.bfloat16).float()
    xv = _token_view(x_flat, t, g, grouped)
    q_flat = torch.zeros(t * g * 128, dtype=torch.int8)
    qv = _token_view(q_flat, t, g, grouped)
    scales = torch.empty((t, 1))
    cmax, cmin = (1.0, 1.0) if clip is None else (float(clip[0]),
                                                  float(clip[1]))
    for i in range(t):
        slab = torch.zeros((kp, 128))
        slab[:g] = xv[i].float()
        z = (a @ slab).to(torch.bfloat16).float()
        assert not z[g:].any()  # the padded rows are zeros
        zr = z[:g]
        xmax = torch.clamp_min(zr.max(), 0.0) * torch.tensor(cmax)
        xmin = torch.clamp_max(zr.min(), 0.0) * torch.tensor(cmin)
        absmax = torch.maximum(xmin.abs(), xmax)
        s = torch.tensor(1.0) if absmax == 0 else absmax / torch.tensor(
            float(q_max))
        scales[i, 0] = s
        qv[i] = torch.clamp(torch.round(zr / s), -q_max - 1, q_max).to(
            torch.int8)
    return q_flat, scales


def _factor(rng, g, kind):
    if kind == "identity":
        return np.eye(g, dtype=np.float32)
    qm, r = np.linalg.qr(rng.standard_normal((g, g)))
    return (qm * np.sign(np.diag(r))).astype(np.float32)


@pytest.mark.parametrize("g,t", [(2, 40), (6, 33), (32, 20), (86, 9)])
@pytest.mark.parametrize("kind", ["identity", "orthogonal"])
@pytest.mark.parametrize("with_clip", [False, True])
def test_padded_tile_matches_plain_and_jax(rng, g, t, kind, with_clip):
    x = jnp.asarray(rng.standard_normal((t, g * 128)) * 3.0, jnp.bfloat16)
    x = x.at[t // 2].set(0.0)  # an all-zero row: scale 1, codes 0
    left_t = jnp.asarray(_factor(rng, g, kind), jnp.bfloat16)
    clip = ((np.float32(0.9), np.float32(0.95)) if with_clip else None)
    jclip = None if clip is None else tuple(jnp.asarray(c) for c in clip)
    tclip = None if clip is None else tuple(torch.tensor(c) for c in clip)
    q_flat, s = _emulate_body(_t(left_t), _t(x).reshape(-1), t, g, tclip, 7,
                              grouped=False)
    q = q_flat.reshape(t, g * 128)
    pq, ps = tfp.left_quant_i8_flat_ref(_t(left_t), _t(x), tclip)
    if kind == "identity":  # one exact product per z: bit-exact
        assert torch.equal(q, pq) and torch.equal(s, ps)
    wq, ws = jfp.left_quant_i8_flat(left_t, x, clip=jclip, interpret=True)
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-6)
    d = np.abs(q.numpy().astype(np.int32) - np.asarray(wq, np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())
    assert s[t // 2].item() == 1.0 and not q[t // 2].any()


@pytest.mark.parametrize("g,t", [(6, 33), (86, 9)])
def test_grouped_maps_give_the_flat_bytes_and_match_jax(rng, g, t):
    """The grouped kernel is the flat one through group-major strides: on
    the same values it writes the same codes, in [G, T, 128]; and it stays
    within the JAX package's bounds of JAX's left_quant_i8_grouped."""
    x = jnp.asarray(rng.standard_normal((t, g * 128)) * 3.0, jnp.bfloat16)
    left_t = jnp.asarray(_factor(rng, g, "orthogonal"), jnp.bfloat16)
    xg = jgm.group_layout(x, g)
    qf, sf = _emulate_body(_t(left_t), _t(x).reshape(-1), t, g, None, 7,
                           grouped=False)
    qg, sg = _emulate_body(_t(left_t), _t(xg).reshape(-1), t, g, None, 7,
                           grouped=True)
    assert torch.equal(sg, sf)
    assert torch.equal(qg.reshape(g, t, 128),
                       tgm.group_layout(qf.reshape(t, g * 128), g))
    wq, ws = jgm.left_quant_i8_grouped(left_t, xg, interpret=True)
    np.testing.assert_allclose(sg.numpy(), np.asarray(ws), rtol=1e-6)
    d = np.abs(qg.reshape(g, t, 128).numpy().astype(np.int32)
               - np.asarray(wq, np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())


def test_padding_leaves_z_and_extrema_unchanged(rng):
    """Zero rows of A past G and zero rows of the slab past G add exact
    zeros to every sum, and the padded rows of z are exact zeros, which
    max(., 0) and min(., 0) already hold: the unpadded product's values."""
    g, t = 86, 5
    x = torch.from_numpy(rng.standard_normal((t, g * 128)).astype(
        np.float32)).to(torch.bfloat16)
    left_t = torch.from_numpy(_factor(rng, g, "orthogonal")).to(
        torch.bfloat16)
    mt, kp = _tile(g)
    assert (mt, kp) == (2, 96)
    a = torch.zeros((64 * mt, kp))
    a[:g, :g] = left_t.float()
    for i in range(t):
        slab = torch.zeros((kp, 128))
        slab[:g] = x[i].reshape(g, 128).float()
        z_pad = (a @ slab).to(torch.bfloat16)
        z = (left_t.float() @ x[i].reshape(g, 128).float()).to(torch.bfloat16)
        assert torch.equal(z_pad[:g], z) and not z_pad[g:].any()
    q, s = quant_acts_i8_ref(
        torch.einsum("ij,tjd->tid", left_t.float(), x.float().reshape(
            t, g, 128)).to(torch.bfloat16).reshape(t, -1), None, 7)
    qe, se = _emulate_body(left_t, x.reshape(-1), t, g, None, 7, False)
    assert torch.equal(se, s)
    d = (qe.reshape(t, -1).int() - q.int()).abs()
    assert d.max() <= 1 and (d > 0).float().mean() < 0.01
