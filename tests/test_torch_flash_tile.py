"""Rows 8 and 15's device body (`flash_prefill_attention` and `_kt`,
kernels/prefill_attention.py, csrc/flash_prefill.cu), on the CPU: the key
order of the wgmma body and the launch glue.

The body keeps the plain version's rounding points (q scaled by sm_scale *
log2 e in float32 and rounded to bf16; float32 scores; an online max and
sum in the exp2 domain; p rounded to bf16 before p v; o / max(l, 1e-30))
but walks the keys in tiles of FLASH_KEY_TILE, so p rounds at the running
max of those tiles, where the plain version (JAX's blocking) takes it over
blocks of 512. A torch emulation of that order must stay within
kernels/tolerance.py's "flash" bound of the plain version and of JAX's
`flash_prefill_attention_kt` (its Pallas kernel in interpret mode, as the
JAX package's own tests run it): the bound's reasoning holds at the
body's tile width.

The CUDA body itself is held to the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py (phases 3e, 6, 8, 9 and 12).
"""

import functools
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from flatquant_tpu.kernels import prefill_attention as jpa
from flatquant_torch.kernels import common
from flatquant_torch.kernels import prefill_attention as tpa
from flatquant_torch.kernels.tolerance import compare_bf16

torch.set_num_threads(2)

SM = 0.088


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _emulate_body(q, k, v, sm_scale, tile):
    """The wgmma body's order in torch: q [B, S, nh, 128], k / v
    [B, S, nkv, 128] bf16 -> [B, S, nh, 128] bf16. Every row runs the key
    tiles of `tile` keys up to its query tile's last row (a tile wholly
    above a row's diagonal masks all its keys and leaves the row's state
    unchanged, so all rows run all tiles here), p rounded at the running
    max of each tile."""
    B, S, nh, hd = q.shape
    n_rep = nh // k.shape[2]
    scale = torch.tensor(sm_scale * 1.4426950408889634, dtype=torch.float32)
    qs = (q.float() * scale).to(torch.bfloat16).float().permute(0, 2, 1, 3)
    kf = k.float().repeat_interleave(n_rep, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(n_rep, dim=2).permute(0, 2, 1, 3)
    row = torch.arange(S)[:, None]
    m = torch.full((B, nh, S, 1), -math.inf)
    l = torch.zeros((B, nh, S, 1))
    acc = torch.zeros((B, nh, S, hd))
    for k0 in range(0, S, tile):
        s = qs @ kf[:, :, k0:k0 + tile].transpose(-1, -2)
        s = torch.where(k0 + torch.arange(tile) > row, -math.inf, s)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p.to(torch.bfloat16).float() @ vf[:, :,
                                                            k0:k0 + tile]
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.to(torch.bfloat16).permute(0, 2, 1, 3)


@functools.lru_cache(maxsize=None)
def _case(S, nh, nkv):
    """Inputs from a seed and the JAX kt kernel's output on them."""
    rng = np.random.default_rng(S * 100 + nh * 10 + nkv)
    q, k, v = [jnp.asarray(rng.standard_normal((1, S, n, 128)),
                           jnp.bfloat16) for n in (nh, nkv, nkv)]
    kt = jnp.transpose(k, (0, 2, 3, 1))
    want = jpa.flash_prefill_attention_kt(q, kt, v, SM, interpret=True)
    return _t(q), _t(k), _t(v), _t(want)


@pytest.mark.parametrize("S", [1024, 1152])
@pytest.mark.parametrize("nh,nkv", [(4, 4), (4, 2), (7, 1)])
def test_body_order_meets_plain_and_jax(S, nh, nkv):
    q, k, v, jax_out = _case(S, nh, nkv)
    got = _emulate_body(q, k, v, SM, tpa.FLASH_KEY_TILE)
    compare_bf16(got, tpa.flash_prefill_attention_ref(q, k, v, SM), "flash",
                 "body order vs plain")
    compare_bf16(got, jax_out, "flash", "body order vs JAX")


# ---------------------------------------------------------------------------
# the launch glue (a fake library records the calls)
# ---------------------------------------------------------------------------


class _FakeLib:
    """Records each entry point a launch calls with its arguments; returns
    `rc`."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def __getattr__(self, name):
        if not name.startswith("fq_"):
            raise AttributeError(name)

        def fn(*args):
            self.calls.append((name, args))
            return self.rc if name != "fq_error_string" else b"fake failure"
        return fn


@pytest.fixture
def fake(monkeypatch):
    def make(rc=0):
        lib = _FakeLib(rc)
        monkeypatch.setattr(common, "lib", lambda stem: lib)
        monkeypatch.setattr(common, "stream_ptr", lambda t: 1234)
        common.reset_launches()
        return lib
    return make


def _qkv(B=2, S=256, nh=8, nkv=2):
    return [torch.zeros((B, S, n, 128), dtype=torch.bfloat16)
            for n in (nh, nkv, nkv)]


@pytest.mark.parametrize("layout", ["token-major view", "contiguous kt"])
def test_flash_launch_passes_kt_strides(fake, layout):
    """The kernel encodes K's tensor map as [B, nkv, S, 128] from the
    strides it is given: the prologue's token-major k seen as a
    [B, nkv, hd, S] view goes in place (token stride nkv * 128, head 128);
    JAX's contiguous kt is first copied token-major per head."""
    lib = fake()
    B, S, nh, nkv = 2, 256, 8, 2
    q, k, v = _qkv(B, S, nh, nkv)
    kt = k.permute(0, 2, 3, 1)  # [B, nkv, hd, S], head-dim stride 1
    if layout == "contiguous kt":
        kt = kt.contiguous()
    out = tpa.launch_flash("flash_prefill_attention_kt", q, kt.permute(
        0, 1, 3, 2), v, SM)
    (name, args), = lib.calls
    assert name == "fq_flash_prefill"
    # q, k, v, out, q (b, s, h), k (b, h, s), v (b, s, h), B, S, nh, nkv,
    # scale, stream
    k_strides = ((S * nkv * 128, 128, nkv * 128) if layout.startswith("token")
                 else (nkv * S * 128, S * 128, 128))
    assert args[4:7] == (S * nh * 128, nh * 128, 128)
    assert args[7:10] == k_strides
    assert args[10:13] == (S * nkv * 128, nkv * 128, 128)
    assert args[13:17] == (B, S, nh, nkv)
    assert args[17] == pytest.approx(SM * 1.4426950408889634)
    assert args[18] == 1234
    if layout.startswith("token"):
        assert args[1] == k.data_ptr()  # read in place, no copy
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert common.LAUNCHES["flash_prefill_attention_kt"] == 1


def test_flash_launch_reads_token_major_k_in_place(fake):
    """flash_prefill_attention's K, [B, S, nkv, hd], reaches the kernel as
    its [B, nkv, S, hd] view: no copy, token stride nkv * 128."""
    lib = fake()
    B, S, nh, nkv = 2, 256, 8, 2
    q, k, v = _qkv(B, S, nh, nkv)
    tpa.launch_flash("flash_prefill_attention", q, k.permute(0, 2, 1, 3), v,
                     SM)
    (name, args), = lib.calls
    assert name == "fq_flash_prefill"
    assert args[1] == k.data_ptr()
    assert args[7:10] == (S * nkv * 128, 128, nkv * 128)
    assert common.LAUNCHES["flash_prefill_attention"] == 1


def test_flash_failed_launch_raises_without_fallback(fake):
    lib = fake(rc=1)
    q, k, v = _qkv()
    with pytest.raises(RuntimeError, match="flash_prefill_attention: kernel "
                       "launch failed"):
        tpa.launch_flash("flash_prefill_attention", q, k.permute(0, 2, 1, 3),
                         v, SM)
    assert [c[0] for c in lib.calls] == ["fq_flash_prefill",
                                         "fq_error_string"]
    assert common.LAUNCHES["flash_prefill_attention"] == 0


@pytest.mark.parametrize("what", ["float32", "S 1000", "heads 6/4",
                                  "head_dim 64", "v of another length"])
def test_flash_launch_refuses_what_the_body_does_not_take(fake, what):
    lib = fake()
    S = 1000 if what == "S 1000" else 256
    nh, nkv = (6, 4) if what == "heads 6/4" else (8, 2)
    q, k, v = _qkv(1, S, nh, nkv)
    if what == "float32":
        q, k, v = q.float(), k.float(), v.float()
    elif what == "head_dim 64":
        q, k, v = (t[..., :64].contiguous() for t in (q, k, v))
    elif what == "v of another length":
        v = v[:, :128]
    with pytest.raises(ValueError):
        tpa.launch_flash("flash_prefill_attention", q, k.permute(0, 2, 1, 3),
                         v, SM)
    assert lib.calls == []
