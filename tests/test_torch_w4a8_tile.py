"""Row 14's device bodies (`w4a8_matmul`, kernels/int4_matmul.py,
csrc/int4_matmul.cu), on the CPU: the route between the weight stream and
the wgmma tile, the tile's register decode of packed nibbles to bf16 on
every byte, its k order with the promotion of the tensor cores' partial
sums, and the launch glue.

The tile decodes two packed bytes at a time: one byte permute spreads them
into the low halfwords of a 32-bit word, a mask leaves one plane's
nibbles, an OR puts each into the mantissa of bf16 128.0 (0x4300) and one
bf16x2 FMA (x 1 - 128) leaves the nibble itself. Stage c of the tile holds
packed bytes [64c, 64c + 64) of its weight rows and the activation columns
they meet, [64c, +64) (low plane) and K/2 + [64c, +64) (high plane); the
k-steps of 8 stages sum on the tensor cores from zero, and those partial
sums are added to the running float32 sums with an IEEE add. The float32
row sums of x come from the same products: the block's last A row is all
ones (the low slice's columns past K/2 skipped), so they are summed and
promoted as the products are. A torch emulation of that order must
meet the plain version (`w4a8_matmul_rowsum_ref`) within the "identity"
tolerance and JAX's `w4a8_matmul` (its Pallas kernel in interpret mode, as
the JAX package's own tests run it) within tests/test_torch_quant_modes.py's
bound.

The CUDA bodies themselves are held to the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py (phases 3g and 9).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from flatquant_tpu.kernels import int4_matmul as jmm
from flatquant_torch.kernels import common
from flatquant_torch.kernels import int4_matmul as tmm
from flatquant_torch.kernels.tolerance import compare_bf16

torch.set_num_threads(2)

# llama-2-7b's four W4A16 linears (N, K): row 14's shapes in phase 9
LLAMA_LINEARS = {"qkv": (12288, 4096), "o": (4096, 4096),
                 "upgate": (22016, 4096), "down": (4096, 11008)}


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("proj", list(LLAMA_LINEARS))
def test_w4a8_route_at_decode_and_prefill(proj):
    """The weight stream at decode (M = 1 to 7: phase 9's B=1 steps), the
    wgmma tile at prefill (the 1 x 2048 prompt) and from M = 9; at M = 8
    the tile for the wide weights (qkv, up||gate: N >= 12288, where phase
    3g measured it faster) and the stream for o and down."""
    n, _ = LLAMA_LINEARS[proj]
    assert (tmm.W4A8_STREAM_MAX_M, tmm.W4A8_WIDE_MIN_M,
            tmm.W4A8_WIDE_N) == (8, 8, 12288)
    wide = proj in ("qkv", "upgate")
    got = [tmm.w4a8_body(m, n) for m in (1, 4, 7, 8, 9, 16, 32, 2048)]
    assert got == ["stream"] * 3 + ["tile" if wide else "stream"] + \
        ["tile"] * 4


@pytest.mark.parametrize("n,body", [(4096, "stream"),
                                    (tmm.W4A8_WIDE_N - 1, "stream"),
                                    (tmm.W4A8_WIDE_N, "tile"),
                                    (22016, "tile")])
def test_w4a8_route_at_m8_by_width(n, body):
    assert tmm.w4a8_body(8, n) == body
    assert tmm.w4a8_body(7, n) == "stream"
    assert tmm.w4a8_body(9, n) == "tile"


# ---------------------------------------------------------------------------
# the register decode
# ---------------------------------------------------------------------------


def _bf16_bits_to_f32(bits):
    return (bits.astype(np.uint32) << np.uint32(16)).view(np.float32)


def nib2_emulation(words, hi):
    """The kernel's nib2_bf16 on uint32 words holding two packed bytes in
    their low halfword -> (low-half value, high-half value) as float32."""
    w = words.astype(np.uint32)
    # byte_perm(v, 0, 0x4140): byte 0 | byte 1 << 16
    t = (w & np.uint32(0xFF)) | ((w & np.uint32(0xFF00)) << np.uint32(8))
    if hi:
        t = t >> np.uint32(4)
    t = (t & np.uint32(0x000F000F)) | np.uint32(0x43004300)
    lo_v = _bf16_bits_to_f32((t & np.uint32(0xFFFF)).astype(np.uint16))
    hi_v = _bf16_bits_to_f32((t >> np.uint32(16)).astype(np.uint16))
    # fma.rn.bf16x2 (t, 1.0, -128.0): 128 + n - 128 is exact in float64,
    # and an integer below 16 is a bf16, so rounding cannot move it
    out = []
    for v in (lo_v, hi_v):
        r = v.astype(np.float64) * 1.0 - 128.0
        r32 = r.astype(np.float32)
        assert (_bf16_bits_to_f32(
            (r32.view(np.uint32) >> np.uint32(16)).astype(np.uint16))
            == r32).all()  # representable in bf16
        out.append(r32)
    return out


@pytest.mark.parametrize("plane", ["lo", "hi"])
def test_nibble_decode_on_all_bytes(plane):
    """Every pair of packed bytes (all 65,536): each half of the bf16 pair
    is its byte's nibble of the plane, the lower k in the low half."""
    b0, b1 = np.meshgrid(np.arange(256, dtype=np.uint32),
                         np.arange(256, dtype=np.uint32), indexing="ij")
    words = (b0 | (b1 << np.uint32(8))).ravel()
    lo_v, hi_v = nib2_emulation(words, plane == "hi")
    shift = 4 if plane == "hi" else 0
    want0 = ((b0.ravel() >> shift) & 0xF).astype(np.float32)
    want1 = ((b1.ravel() >> shift) & 0xF).astype(np.float32)
    np.testing.assert_array_equal(lo_v, want0)
    np.testing.assert_array_equal(hi_v, want1)


# ---------------------------------------------------------------------------
# the tile's sum order
# ---------------------------------------------------------------------------


# W8T_PROMOTE in csrc/int4_matmul.cu: stages summed on the tensor cores
# before the partial sums are added to the running ones
KERNEL_PROMOTE = 8


def tile_emulation(x, sx, wp, sw, promote=KERNEL_PROMOTE):
    """The tile's float32 sums in its order (torch, float32): per stage of
    64 packed bytes the two planes' products and the row sums of their
    128 columns (the tensor cores' partial sums, here float32 matmuls and
    sums), started from zero and added to acc and rowsum every `promote`
    stages (each stage of a last group of fewer stages on its own); the
    plain version's epilogue. Returns float32 [M, N]."""
    m, k = x.shape
    n, half = wp.shape
    xf = x.to(torch.float32)
    stages = -(-half // 64)
    pad = stages * 64 - half
    nib_lo = torch.nn.functional.pad((wp & 0xF).to(torch.float32), (0, pad))
    nib_hi = torch.nn.functional.pad((wp >> 4).to(torch.float32), (0, pad))
    x_lo = torch.nn.functional.pad(xf[:, :half], (0, pad))  # zeros past K/2
    x_hi = torch.nn.functional.pad(xf[:, half:], (0, pad))
    acc = torch.zeros((m, n), dtype=torch.float32)
    rowsum = torch.zeros((m, 1), dtype=torch.float32)
    full = stages // promote * promote
    groups = [range(g, g + promote) for g in range(0, full, promote)]
    groups += [range(c, c + 1) for c in range(full, stages)]
    for group in groups:
        part = torch.zeros((m, n), dtype=torch.float32)
        rpart = torch.zeros((m, 1), dtype=torch.float32)
        for c in group:
            sl = slice(64 * c, 64 * c + 64)
            part = part + x_lo[:, sl] @ nib_lo[:, sl].T
            part = part + x_hi[:, sl] @ nib_hi[:, sl].T
            rpart = rpart + torch.cat([x_lo[:, sl], x_hi[:, sl]], 1).sum(
                1, keepdim=True)
        acc = acc + part
        rowsum = rowsum + rpart
    return (acc - 8.0 * rowsum) * sx.reshape(-1, 1) * sw.reshape(1, -1)


def _inputs(rng, m, n, k, acts):
    wp = rng.integers(0, 256, (n, k // 2)).astype(np.uint8)
    ws = rng.uniform(0.005, 0.02, (n,)).astype(np.float32)
    if acts == "codes":
        x = rng.integers(-8, 8, (m, k)).astype(np.float32)
        xs = rng.uniform(0.01, 0.5, (m, 1)).astype(np.float32)
    else:
        x = rng.standard_normal((m, k)).astype(np.float32)
        xs = np.ones((m, 1), np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    return xb, torch.from_numpy(xs), torch.from_numpy(wp), torch.from_numpy(ws)


@pytest.mark.parametrize("k", [128, 2880, 4096])
@pytest.mark.parametrize("acts", ["codes", "bf16 activations"])
def test_tile_order_meets_plain_and_jax(rng, k, acts):
    """K = 128 (one stage), 2880 (a last stage of 32 packed bytes: the low
    slice's upper half is past K/2, its weights zero-filled) and 4096."""
    m, n = 20, 72
    x, xs, wp, ws = _inputs(rng, m, n, k, acts)
    emu = tile_emulation(x, xs, wp, ws)
    plain = tmm.w4a8_matmul_rowsum_ref(x, xs, wp, ws, torch.float32)
    want = np.asarray(jmm.w4a8_matmul(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(xs.numpy()),
        jnp.asarray(wp.numpy()), jnp.asarray(ws.numpy()), jnp.float32,
        block_m=64, block_n=128, interpret=True))
    if acts == "codes":  # integer sums: exact in every order
        assert torch.equal(emu, plain)
        np.testing.assert_array_equal(emu.numpy(), want)
    else:
        scale = np.abs(want).max(axis=-1, keepdims=True)
        assert (np.abs(emu.numpy() - want) <= 1e-5 * scale).all()
        compare_bf16(emu.to(torch.bfloat16),
                     tmm.w4a8_matmul_rowsum_ref(x, xs, wp, ws),
                     "identity", f"tile order K={k}")


@pytest.mark.parametrize("promote", [1, 2, 4, KERNEL_PROMOTE])
def test_promotion_lengths_meet_identity_at_k_11008(rng, promote):
    """The partial sums promoted every 1 to 8 stages (128 to 1024 k; the
    kernel's 8 and a last group of 6): the emulated order stays within
    "identity" of the plain version at llama-2-7b's down projection K."""
    m, n, k = 8, 48, 11008
    x, xs, wp, ws = _inputs(rng, m, n, k, "bf16 activations")
    emu = tile_emulation(x, xs, wp, ws, promote)
    compare_bf16(emu.to(torch.bfloat16),
                 tmm.w4a8_matmul_rowsum_ref(x, xs, wp, ws), "identity",
                 f"promote {promote}")


# ---------------------------------------------------------------------------
# the launch glue: the picked body's entry point, no fallback
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


def _w4a8_launch(m, n=576, k=256, out=torch.bfloat16):
    return tmm.launch_w4a8(torch.zeros((m, k), dtype=torch.bfloat16),
                           torch.ones((m, 1)),
                           torch.zeros((n, k // 2), dtype=torch.uint8),
                           torch.ones(n), out, m, n, k)


@pytest.mark.parametrize("m", [1, 8, 9, 2048])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_w4a8_launch_takes_the_picked_entry_point(fake, m, out):
    lib = fake()
    y = _w4a8_launch(m, out=out)
    body = tmm.w4a8_body(m, 576)
    (name, args), = lib.calls
    assert name == f"fq_w4a8_matmul_{body}"
    # x, wp, sx, sw, y, M, N, K, out_is_f32, stream
    assert args[5:] == (m, 576, 256, int(out == torch.float32), 1234)
    assert y.shape == (m, 576) and y.dtype == out
    assert common.LAUNCHES["w4a8_matmul"] == 1
    assert common.BODY_LAUNCHES["w4a8_matmul"] == {
        b: int(b == body) for b in tmm.W4A8_BODIES}


@pytest.mark.parametrize("m", [4, 2048])
def test_w4a8_failed_launch_raises_without_fallback(fake, m):
    lib = fake(rc=1)
    with pytest.raises(RuntimeError, match="w4a8_matmul: kernel launch "
                       "failed"):
        _w4a8_launch(m)
    assert [c[0] for c in lib.calls] == [
        f"fq_w4a8_matmul_{tmm.w4a8_body(m, 576)}", "fq_error_string"]
    assert common.LAUNCHES["w4a8_matmul"] == 0
    assert sum(common.BODY_LAUNCHES["w4a8_matmul"].values()) == 0
