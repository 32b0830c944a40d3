"""Row 7's bf16 device body (`attn_prologue`, kernels/attn_prologue.py,
csrc/attn_prologue.cu), on the CPU: the route between the two bodies, the
register layouts the body's RoPE and quantization rely on, its order of
the head products, and the launch glue.

The bf16 body gives each warp 16 tokens of a head as the A fragments of
mma.m16n8k16 (= wgmma's register A per warp): slot f of k-step kk holds
row g8 + 8 (f & 1) and columns 16kk + 8 (f >> 1) + 2tq + e. A column's
rotate_half partner, c ^ 64, sits in the same slot of k-step kk ^ 4, with
a minus sign for kk < 4, so RoPE needs no shuffle. The product is 8
wgmma k-steps of 16 with float32 sums; its accumulators hold row g8 + 8
(e >> 1), column 8j + 2tq + (e & 1) of n-tile j. The int4 quantization
of K reads them there and V's in the A layout: in both, a thread holds
columns 8J + 2tq + e (J < 8) of a row and their planar partners 64 on,
so each code byte packs from one thread's registers and the row's max
and min take a quad shuffle. Torch emulations of those maps must give
`attn_prologue_ref`'s rope and `quantize_pack_kv`'s bytes bit for bit,
and the emulated body must be bit-exact with identity factors and within
the "orthogonal" tolerance with random orthogonal ones, against the plain
version and JAX's `attn_prologue` (its Pallas kernel in interpret mode,
as the JAX package's own tests run it).

The CUDA bodies themselves are held to the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py (phases 3d, 5, 6, 8 and 12).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from flatquant_tpu.kernels.attn_prologue import attn_prologue as j_prologue
from flatquant_tpu.kernels.kv_cache import untranspose_kv as j_untranspose
from flatquant_tpu.models.config import LlamaConfig as JLlamaConfig
from flatquant_tpu.models.llama import rope_tables as j_rope_tables
from flatquant_torch.core.quant import true_div
from flatquant_torch.kernels import attn_prologue as tap
from flatquant_torch.kernels import common
from flatquant_torch.kernels.kv_cache import quantize_pack_kv
from flatquant_torch.kernels.tolerance import (
    compare_bf16,
    compare_codes,
    compare_scales,
)
from flatquant_torch.models.llama import rotate_half

torch.set_num_threads(2)

HD = 128


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _orthogonal(rng, n):
    qm, r = np.linalg.qr(rng.standard_normal((n, n)))
    return (qm * np.sign(np.diag(r))).astype(np.float32)


# ---------------------------------------------------------------------------
# the register maps (one warp's 16 rows, lanes g8 = lane / 4, tq = lane % 4)
# ---------------------------------------------------------------------------


def _a_map():
    """(row, column) of A-fragment element [kk, f, lane, e]: slot f of
    k-step kk, half e of its bf16 pair."""
    kk, f, lane, e = np.meshgrid(np.arange(8), np.arange(4), np.arange(32),
                                 np.arange(2), indexing="ij")
    g8, tq = lane // 4, lane % 4
    return g8 + 8 * (f & 1), 16 * kk + 8 * (f >> 1) + 2 * tq + e


def _c_map():
    """(row, column) of accumulator element [j, lane, i] of the m64n128
    wgmma (one warp's rows): n-tile j, register 4j + i."""
    j, lane, i = np.meshgrid(np.arange(16), np.arange(32), np.arange(4),
                             indexing="ij")
    g8, tq = lane // 4, lane % 4
    return g8 + 8 * (i >> 1), 8 * j + 2 * tq + (i & 1)


def test_fragment_maps_cover_each_element_once():
    for rows, cols in (_a_map(), _c_map()):
        flat = (rows * HD + cols).ravel()
        assert sorted(flat.tolist()) == list(range(16 * HD))


def _rope_in_fragments(x, c, s):
    """rope of a warp's [16, 128] bf16 tile as the body runs it: each
    element of (kk, f, lane, e) with the same slot of k-step kk ^ 4 as its
    rotate_half partner, negated for kk < 4, a bf16 rounding after each
    op. Returns the roped tile scattered back to [16, 128]."""
    rows, cols = _a_map()
    xf = x.float()[rows, cols]                      # [8, 4, 32, 2]
    partner = xf[np.arange(8) ^ 4]                  # same (f, lane, e)
    sign = torch.tensor([-1.0] * 4 + [1.0] * 4).view(8, 1, 1, 1)
    rh = sign * partner

    def rnd(v):
        return v.to(torch.bfloat16).float()

    y = rnd(rnd(xf * c.float()[rows, cols]) + rnd(rh * s.float()[rows, cols]))
    out = torch.empty((16, HD), dtype=torch.float32)
    out[rows, cols] = y
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_register_rope_matches_plain_rope(seed):
    """The partner at kk ^ 4 in the same slot, with the sign of kk < 4, is
    rotate_half's: bit for bit against attn_prologue_ref's bf16 rope."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((16, HD)).astype(np.float32)
                         * 3).to(torch.bfloat16)
    ang = torch.from_numpy(rng.uniform(0, 6.3, (16, HD)).astype(np.float32))
    c, s = torch.cos(ang).to(torch.bfloat16), torch.sin(ang).to(torch.bfloat16)
    want = x * c + rotate_half(x) * s  # bf16 tensors: a rounding per op
    assert torch.equal(_rope_in_fragments(x, c, s), want)


def _quant_rows_in_fragments(vals, rows, cols, clip):
    """The body's quantization of a warp's 16 rows from registers laid out
    by (rows, cols) of a map: per row, each quad's values at columns 8J +
    2tq + e (J < 8) and their partners 64 on, max and min over the quad,
    then quant_pack_row's arithmetic; byte 8J + 2tq + e of the row packs
    the low code and the partner's. Returns (codes [16, 64] uint8,
    scale [16, 1], zero [16, 1])."""
    full = torch.empty((16, HD), dtype=torch.float32)
    full[rows, cols] = vals
    lo_cols = np.array([8 * J + 2 * tq + e for tq in range(4)
                        for J in range(8) for e in range(2)])
    lo, hi = full[:, lo_cols], full[:, lo_cols + 64]
    both = torch.cat([lo, hi], dim=1)
    tmax = torch.clamp(both.amax(dim=1, keepdim=True), min=0.0)
    tmin = torch.clamp(both.amin(dim=1, keepdim=True), max=0.0)
    cmax, cmin = clip
    tmax, tmin = tmax * cmax, tmin * cmin
    degenerate = (tmin == 0) & (tmax == 0)
    tmin = torch.where(degenerate, -1.0, tmin)
    tmax = torch.where(degenerate, 1.0, tmax)
    scale = true_div(tmax - tmin, 15.0)
    zero = torch.round(-tmin / scale)

    def code(v):
        return torch.clamp(torch.round(v / scale) + zero, 0, 15).to(
            torch.uint8)

    codes = torch.empty((16, 64), dtype=torch.uint8)
    codes[:, lo_cols] = code(lo) | (code(hi) << 4)
    return codes, scale, zero


@pytest.mark.parametrize("layout", ["accumulators (K)", "A fragments (V)"])
@pytest.mark.parametrize("clip", [(1.0, 1.0), (0.93, 0.9)])
@pytest.mark.parametrize("seed", [0, 1])
def test_packing_from_fragments_matches_quantize_pack_kv(layout, clip, seed):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy(rng.standard_normal((16, HD)).astype(np.float32)
                         * 2).to(torch.bfloat16).float()
    t[3] = 0.0  # the degenerate row: (-1, 1)
    t[5] = t[5].abs()  # no negative value: tmin 0
    rows, cols = _c_map() if layout.startswith("acc") else _a_map()
    codes, scale, zero = _quant_rows_in_fragments(t[rows, cols], rows, cols,
                                                  clip)
    clips = (torch.tensor(clip[0]), torch.tensor(clip[1]))
    pk, sc, zr = quantize_pack_kv(t, clips)
    assert torch.equal(codes, pk)
    assert torch.equal(scale, sc) and torch.equal(zero, zr)


# ---------------------------------------------------------------------------
# the bf16 body's order: rope in registers, 16-deep k-steps
# ---------------------------------------------------------------------------


def _emulate_mma_body(qkv, cos, sin, k_t, k_t_inv, kc_clip, vc_clip, nh,
                      nkv):
    """The bf16 body in torch on the CPU: per 16-token warp tile, rope
    through the fragment map, the head product as 8 k-steps of 16 whose
    float32 partial products are added in order, bf16 outputs, K
    quantized from them and V from the raw values through the fragment
    maps. Returns (q_rot, k_rot, k codes, k params, v codes, v params) in
    attn_prologue_ref's layouts (codes/params [B, nkv, S, .])."""
    B, S, _ = qkv.shape
    assert S % 16 == 0
    c16 = cos.to(torch.bfloat16)
    s16 = sin.to(torch.bfloat16)
    mats = {"q": k_t_inv.to(torch.bfloat16).float(),
            "k": k_t.to(torch.bfloat16).float()}
    q_rot = torch.empty((B, S, nh * HD), dtype=torch.bfloat16)
    k_rot = torch.empty((B, S, nkv * HD), dtype=torch.bfloat16)
    kc = torch.empty((B, nkv, S, 64), dtype=torch.uint8)
    vc = torch.empty_like(kc)
    kp = torch.empty((B, nkv, S, 2))
    vp = torch.empty_like(kp)
    arows, acols = _a_map()
    crows, ccols = _c_map()
    for b in range(B):
        for t0 in range(0, S, 16):
            rows = slice(t0, t0 + 16)
            c, s = c16[rows], s16[rows]
            for kind, n, off in (("q", nh, 0), ("k", nkv, nh), ("v", nkv,
                                                               nh + nkv)):
                for h in range(n):
                    col = (off + h) * HD
                    x = qkv[b, rows, col:col + HD]
                    if kind == "v":
                        codes, sc, zr = _quant_rows_in_fragments(
                            x.float()[arows, acols], arows, acols,
                            vc_clip or (1.0, 1.0))
                        vc[b, h, rows], vp[b, h, rows] = codes, torch.cat(
                            [sc, zr], dim=1)
                        continue
                    a = _rope_in_fragments(x, c, s).float()
                    acc = torch.zeros((16, HD))
                    for kk in range(8):
                        ks = slice(16 * kk, 16 * kk + 16)
                        acc = acc + a[:, ks] @ mats[kind][ks]
                    y = acc.to(torch.bfloat16)
                    if kind == "q":
                        q_rot[b, rows, h * HD:(h + 1) * HD] = y
                        continue
                    k_rot[b, rows, h * HD:(h + 1) * HD] = y
                    codes, sc, zr = _quant_rows_in_fragments(
                        y.float()[crows, ccols], crows, ccols,
                        kc_clip or (1.0, 1.0))
                    kc[b, h, rows], kp[b, h, rows] = codes, torch.cat(
                        [sc, zr], dim=1)
    return q_rot, k_rot, kc, kp, vc, vp


def _prologue_inputs(rng, B, S, nh, nkv, mode):
    jcfg = JLlamaConfig(name="t", hidden_size=nh * HD, num_heads=nh,
                        num_kv_heads=nkv, head_dim=HD)
    qkv = jnp.asarray(rng.standard_normal((B, S, (nh + 2 * nkv) * HD)) * 2,
                      jnp.bfloat16)
    cos, sin = j_rope_tables(jcfg, jnp.arange(S))
    if mode == "identity":
        k_t = k_t_inv = jnp.eye(HD, dtype=jnp.float32)
    else:
        k_t = jnp.asarray(_orthogonal(rng, HD))
        k_t_inv = jnp.asarray(_orthogonal(rng, HD))
    return qkv, cos, sin, k_t, k_t_inv


@pytest.mark.parametrize("mode", ["identity", "orthogonal"])
@pytest.mark.parametrize("nh,nkv", [(3, 2), (7, 1)])
def test_emulated_mma_body_meets_plain_and_jax(rng, mode, nh, nkv):
    B, S = 2, 64
    qkv, cos, sin, k_t, k_t_inv = _prologue_inputs(rng, B, S, nh, nkv, mode)
    kclip = (np.float32(0.92), np.float32(0.9))
    tk = (torch.tensor(kclip[0]), torch.tensor(kclip[1]))
    args = (_t(qkv), _t(cos), _t(sin), _t(k_t), _t(k_t_inv))
    got = _emulate_mma_body(*args, tk, None, nh, nkv)
    want = tap.attn_prologue_ref(*args, tk, None, nh=nh, nkv=nkv)
    jw = j_prologue(qkv, cos, sin, k_t, k_t_inv, (jnp.float32(kclip[0]),
                    jnp.float32(kclip[1])), None, nh=nh, nkv=nkv,
                    interpret=True)
    j_k = _t(jw[1]).permute(0, 3, 1, 2).reshape(B, S, nkv * HD)
    for i, name, j_ref in ((0, "q_rot", _t(jw[0])), (1, "k_rot", j_k)):
        if mode == "identity":  # one nonzero product per output: exact
            assert torch.equal(got[i], want[i]), name
        compare_bf16(got[i], want[i], mode, f"{name} vs plain")
        compare_bf16(got[i], j_ref, mode, f"{name} vs JAX")
    # V from the raw values: bit for bit in both modes
    assert torch.equal(got[4], want[5]) and torch.equal(got[5], want[6])
    compare_codes(got[2], want[3], mode, "K codes", packed=True)
    compare_scales(got[3][..., 0], want[4][..., 0], mode, "K scales")
    if mode == "identity":
        assert torch.equal(got[2], want[3]) and torch.equal(got[3], want[4])
    for codes, params, jc, jp in ((got[2], got[3], jw[3], jw[4]),
                                  (got[4], got[5], jw[5], jw[6])):
        pk, sc, zr = j_untranspose(jc, jp)
        # JAX's own plain-vs-kernel bound (tests/test_torch_prefill.py)
        compare_codes(codes, _t(pk), "orthogonal", "codes vs JAX",
                      packed=True)
        np.testing.assert_allclose(params[..., 0].numpy(),
                                   np.asarray(sc)[..., 0], rtol=1e-6)


# ---------------------------------------------------------------------------
# the route and the launch glue (a fake library records the calls)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,nh,nkv,heads", [
    (4, 512, 32, 32, (4, 2)),    # phase 5: 768 blocks
    (1, 2048, 32, 32, (4, 2)),   # llama-2-7b's 1 x 2048
    (1, 2048, 28, 4, (2, 1)),    # Qwen-2.5-7B's: 288 blocks at (4, 2)
    (4, 128, 32, 32, (1, 1)),    # the 4 x 128 prefill: as many as it gets
    (1, 200, 8, 2, (1, 1))])
def test_prologue_heads_fill_the_card(B, S, nh, nkv, heads):
    """4 q heads or 2 k (+ 2 v) heads a block, halved while the grid holds
    fewer than PRO_MIN_BLOCKS blocks (down to one head)."""
    assert tap.prologue_heads(B, S, nh, nkv) == heads
    qh, kvh = heads
    blocks = B * -(-S // 64) * (-(-nh // qh) + -(-nkv // kvh))
    assert blocks >= tap.PRO_MIN_BLOCKS or qh == 1


def test_prologue_route_by_dtype():
    assert tap.prologue_body(torch.bfloat16) == "mma"
    assert tap.prologue_body(torch.float32) == "simt"
    assert set(common.BODY_LAUNCHES["attn_prologue"]) == {"simt", "mma"}


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


def _launch(dtype, nh=4, nkv=2, B=2, S=48, L=96, pos=40):
    qkv = torch.zeros((B, S, (nh + 2 * nkv) * HD), dtype=dtype)
    cs = torch.zeros((S, HD), dtype=torch.bfloat16)
    cache = [torch.zeros((B, nkv, L, 64), dtype=torch.uint8),
             torch.zeros((B, nkv, L, 2)),
             torch.zeros((B, nkv, L, 64), dtype=torch.uint8),
             torch.zeros((B, nkv, L, 2))]
    return tap.launch_prologue(qkv, cs, cs, torch.eye(HD), torch.eye(HD),
                               torch.ones(4), cache, nh, nkv, pos)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prologue_launch_takes_the_picked_body(fake, dtype):
    """bf16 qkv launches the tensor-core body, float32 the CUDA-core one,
    each counted in BODY_LAUNCHES; the products' matrices reach the
    tensor-core body transposed in bf16, the CUDA-core body in float32."""
    lib = fake()
    q_rot, k_rot = _launch(dtype)
    body = tap.prologue_body(dtype)
    (name, args), = lib.calls
    assert name == {"mma": "fq_attn_prologue_mma",
                    "simt": "fq_attn_prologue"}[body]
    # ..., B, S, nh, nkv, L, pos, is_f32 (simt) or the heads a block walks
    # (mma), stream
    extra = (1,) if body == "simt" else tap.prologue_heads(2, 48, 4, 2)
    assert args[12:] == (2, 48, 4, 2, 96, 40, *extra, 1234)
    assert q_rot.shape == (2, 48, 4 * HD) and k_rot.shape == (2, 48, 2 * HD)
    assert q_rot.dtype == k_rot.dtype == dtype
    assert common.LAUNCHES["attn_prologue"] == 1
    assert common.BODY_LAUNCHES["attn_prologue"] == {
        b: int(b == body) for b in ("simt", "mma")}


def test_prologue_mma_body_reads_transposed_bf16_factors(fake, monkeypatch):
    seen = []
    real = torch.Tensor.contiguous

    def spy(t, *a, **k):
        out = real(t, *a, **k)
        seen.append(out)
        return out

    lib = fake()
    monkeypatch.setattr(torch.Tensor, "contiguous", spy)
    k_t = torch.arange(HD * HD, dtype=torch.float32).reshape(HD, HD)
    qkv = torch.zeros((1, 16, 3 * HD), dtype=torch.bfloat16)
    cs = torch.zeros((16, HD), dtype=torch.bfloat16)
    cache = [torch.zeros((1, 1, 16, 64), dtype=torch.uint8),
             torch.zeros((1, 1, 16, 2)),
             torch.zeros((1, 1, 16, 64), dtype=torch.uint8),
             torch.zeros((1, 1, 16, 2))]
    tap.launch_prologue(qkv, cs, cs, k_t, 2 * k_t, torch.ones(4), cache, 1,
                        1, 0)
    monkeypatch.undo()
    (_, args), = lib.calls
    mats = {t.data_ptr(): t for t in seen}
    mt, mti = mats[args[3]], mats[args[4]]
    assert torch.equal(mt, k_t.to(torch.bfloat16).t())
    assert torch.equal(mti, (2 * k_t).to(torch.bfloat16).t())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prologue_failed_launch_raises_without_fallback(fake, dtype):
    lib = fake(rc=1)
    with pytest.raises(RuntimeError, match="attn_prologue: kernel launch "
                       "failed"):
        _launch(dtype)
    body = tap.prologue_body(dtype)
    assert [c[0] for c in lib.calls] == [tap._BODY_FN[body],
                                         "fq_error_string"]
    assert common.LAUNCHES["attn_prologue"] == 0
    assert sum(common.BODY_LAUNCHES["attn_prologue"].values()) == 0
