"""Row 1's two device bodies (kernels/int4_matmul.py, csrc/int4_matmul.cu),
on the CPU: the route between them, the arithmetic the tensor-core tile
body relies on, and the launch glue.

The tile body unpacks four packed bytes at a time into 16 * (nibble - 8)
as signed bytes (hi = (w & 0xF0) ^ 0x80, lo = ((w << 4) & 0xF0) ^ 0x80 on
each byte), sums them against the activation codes in int32 in its
k-step order (stages of 64 packed bytes, steps of 32, the low plane then
the high; zero-filled activations past K/2) and divides by 16 exactly.
A numpy emulation of that order must equal the plain version
(`w4a8_matmul_ref`) and JAX's `w4a4_matmul_i8` (its Pallas kernel in
interpret mode, as the JAX package's own tests run it) bit for bit.

The CUDA bodies themselves are held to the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py (phases 3a, 3h, 3j).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from flatquant_tpu.kernels import int4_matmul as jmm
from flatquant_torch.kernels import common
from flatquant_torch.kernels import int4_matmul as tmm

torch.set_num_threads(2)

# the row-1 linears of the registered models the port serves, (N, K):
# llama-2-7b (hidden 4096, intermediate 11008, merged qkv and up||gate),
# Qwen-2.5-7B (hidden 3584, 28/4 heads of 128, intermediate 18944) and
# DeepSeek-V2-Lite's packed W4A4 form (dim 2048, wkv_a 512 + 64 rows,
# 16 heads of 192 / 128, dense inter 10944, 2 shared experts of 1408)
ROW1_SHAPES = {
    "llama-2-7b qkv": (12288, 4096),
    "llama-2-7b o": (4096, 4096),
    "llama-2-7b upgate": (22016, 4096),
    "llama-2-7b down": (4096, 11008),
    "qwen-2.5-7b qkv": (4608, 3584),
    "qwen-2.5-7b o": (3584, 3584),
    "qwen-2.5-7b down": (3584, 18944),
    "deepseek-v2-lite wkv_a": (576, 2048),
    "deepseek-v2-lite wq": (3072, 2048),
    "deepseek-v2-lite dense w2": (2048, 10944),
    "deepseek-v2-lite shared w2": (2048, 2816),
}
DECODE_M = (1, 4, 8)
PREFILL_M = (192, 256, 2048)  # phase 4's prompt, the batcher's chunk, 1 x 2048


@pytest.mark.parametrize("proj", list(ROW1_SHAPES))
def test_route_stream_at_decode_tile_at_prefill(proj):
    n, k = ROW1_SHAPES[proj]
    assert [tmm.w4a4_body(m, n, k) for m in DECODE_M] == ["stream"] * 3
    assert [tmm.w4a4_body(m, n, k) for m in PREFILL_M] == ["tile"] * 3


@pytest.mark.parametrize("k", [96, 2848, 10944 + 32])
def test_route_rule_for_k_32_mod_64(k):
    """K % 64 == 32 (a last stage of 16 packed bytes) takes the same rule
    as any K: the tile from TILE_MIN_M rows on."""
    assert k % 64 == 32
    m0 = tmm.TILE_MIN_M
    assert 8 < m0 <= 192
    assert tmm.w4a4_body(m0 - 1, 4096, k) == "stream"
    assert tmm.w4a4_body(m0, 4096, k) == "tile"
    assert tmm.w4a4_body(m0, 4096, tmm.TILE_MAX_K) == "stream"


# ---------------------------------------------------------------------------
# the tile body's arithmetic
# ---------------------------------------------------------------------------


def _codes16(words, plane):
    """The kernel's bit formula on uint32 words of packed bytes (little
    endian, as the card loads them) -> int8 bytes 16 * (nibble - 8)."""
    w = words.astype(np.uint32)
    if plane == "lo":
        w = (w << np.uint32(4)) & np.uint32(0xF0F0F0F0)
    else:
        w = w & np.uint32(0xF0F0F0F0)
    return (w ^ np.uint32(0x80808080)).astype("<u4").view(np.int8)


@pytest.mark.parametrize("plane", ["lo", "hi"])
def test_signed_code_formula_on_all_bytes(plane):
    b = np.arange(256, dtype=np.uint8)
    nib = (b & 0xF) if plane == "lo" else (b >> 4)
    want = 16 * (nib.astype(np.int32) - 8)
    # every byte value at every position of a word, beside every other
    for shift in range(4):
        words = np.roll(b, shift).view("<u4")
        got = _codes16(words, plane).astype(np.int32)
        np.testing.assert_array_equal(got, np.roll(want, shift))


def tile_emulation(xq, xs, wp, ws):
    """The tile body's int32 sums in its k-step order and its epilogue, in
    numpy: float32 [M, N] before the cast to the output type."""
    acc = tile_sums(xq, wp)
    return (acc.astype(np.float32) * xs) * ws.reshape(1, -1)


def tile_sums(xq, wp):
    """The tile body's int32 sums in its k-step order, / 16: sum_k x *
    (nib - 8) as int32 [M, N]."""
    m, k = xq.shape
    n, half = wp.shape
    stages = -(-half // 64)
    pad = stages * 64 - half
    # zero-filled chunks past K/2: packed byte 0 (codes -128) against
    # zero activations
    wpp = np.pad(wp, ((0, 0), (0, pad)))
    lo_x = np.pad(xq[:, :half], ((0, 0), (0, pad))).astype(np.int64)
    hi_x = np.pad(xq[:, half:], ((0, 0), (0, pad))).astype(np.int64)
    words = np.ascontiguousarray(wpp).view("<u4")
    lo_w = _codes16(words, "lo").reshape(n, -1).astype(np.int64)
    hi_w = _codes16(words, "hi").reshape(n, -1).astype(np.int64)
    acc = np.zeros((m, n), np.int64)
    for st in range(stages):
        for step in range(2):
            c = st * 64 + step * 32
            sl = slice(c, c + 32)
            acc += lo_x[:, sl] @ lo_w[:, sl].T
            acc += hi_x[:, sl] @ hi_w[:, sl].T
            assert np.abs(acc).max() < 2 ** 31  # the int32 never wraps
    assert (acc % 16 == 0).all()
    return (acc >> 4).astype(np.int32)


def _inputs(rng, m, n, k, case):
    xs = rng.uniform(0.01, 0.5, (m, 1)).astype(np.float32)
    ws = rng.uniform(0.001, 0.05, (n,)).astype(np.float32)
    if case == "random":
        xq = rng.integers(-8, 8, (m, k)).astype(np.int8)
        wp = rng.integers(0, 256, (n, k // 2)).astype(np.uint8)
    else:  # extreme codes: x = -8 against nibbles 0 and 15 in both planes
        xq = np.full((m, k), -8, np.int8)
        xq[1::2, ::3] = 7
        wp = np.array([0x00, 0xFF, 0x0F, 0xF0], np.uint8)[
            rng.integers(0, 4, (n, k // 2))]
        wp[0] = 0x00  # a row of nibbles 0: q = -8 everywhere
    return xq, xs, wp, ws


@pytest.mark.parametrize("k,case,out", [
    (96, "random", "float32"), (96, "extreme", "bfloat16"),
    (2848, "random", "bfloat16"), (2848, "extreme", "float32"),
    (4096, "random", "float32"), (4096, "extreme", "bfloat16"),
    (10944, "random", "bfloat16"), (10944, "extreme", "float32"),
    (18944, "random", "float32"), (18944, "extreme", "bfloat16")])
def test_tile_order_equals_plain_and_jax(rng, k, case, out):
    m, n = 24, 72
    xq, xs, wp, ws = _inputs(rng, m, n, k, case)
    dt = getattr(torch, out)
    emu = torch.from_numpy(tile_emulation(xq, xs, wp, ws)).to(dt)
    plain = tmm.w4a8_matmul_ref(torch.from_numpy(xq), torch.from_numpy(xs),
                                torch.from_numpy(wp), torch.from_numpy(ws),
                                dt)
    assert torch.equal(emu, plain)
    want = jmm.w4a4_matmul_i8(jnp.asarray(xq), jnp.asarray(xs),
                              jnp.asarray(wp), jnp.asarray(ws),
                              jnp.dtype(out), interpret=True)
    np.testing.assert_array_equal(emu.float().numpy(),
                                  np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# the swiglu GEMMs (rows 6, 13, 22, 27) on the same tile
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,nh", [(24, 2880, 128), (40, 896, 256),
                                    (16, 4096, 128)])
def test_swiglu_tile_sums_equal_jax(rng, m, k, nh):
    """The swiglu body runs the tile's main loop on the up rows [0, nh) and
    the gate rows [nh, 2nh) of the merged weight: its signed-code int32
    sums equal JAX's acc - 8 * rowsum (its kernels' integer algebra) for
    both, and its float32 epilogue on them meets JAX's
    w4a4_matmul_i8_swiglu (interpret mode) within
    tests/test_torch_quant_modes.py's bound and the port's plain version
    bit for bit."""
    xq = rng.integers(-8, 8, (m, k)).astype(np.int8)
    xq[0] = -8  # an extreme row
    xs = rng.uniform(0.1, 1.0, (m, 1)).astype(np.float32)
    wp = rng.integers(0, 256, (2 * nh, k // 2)).astype(np.uint8)
    sw = rng.uniform(0.01, 0.1, (2 * nh,)).astype(np.float32)
    nib = np.concatenate([wp & 0xF, wp >> 4], axis=1).astype(np.int64)
    rowsum = xq.astype(np.int64).sum(axis=1, keepdims=True)
    sums = {}
    for mat, rows in (("up", slice(0, nh)), ("gate", slice(nh, 2 * nh))):
        sums[mat] = tile_sums(xq, wp[rows])
        jax_acc = np.asarray(jnp.matmul(
            jnp.asarray(xq, jnp.int32), jnp.asarray(nib[rows].T, jnp.int32)))
        np.testing.assert_array_equal(sums[mat], jax_acc - 8 * rowsum)
    u = (sums["up"].astype(np.float32) * xs) * sw[:nh]
    g = (sums["gate"].astype(np.float32) * xs) * sw[nh:]
    t = torch.from_numpy
    gt = t(g)
    emu = (t(u) * (gt * (1.0 / (1.0 + torch.exp(-gt))))).numpy()
    want = np.asarray(jmm.w4a4_matmul_i8_swiglu(
        jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(wp), jnp.asarray(sw),
        out_dtype=jnp.float32, interpret=True))
    np.testing.assert_allclose(emu, want, rtol=2e-6, atol=2e-6)
    plain = tmm.w4a4_matmul_i8_swiglu_ref(t(xq), t(xs), t(wp), t(sw),
                                          torch.float32)
    np.testing.assert_array_equal(emu, plain.numpy())


# ---------------------------------------------------------------------------
# the launch glue: the picked body's entry point, no fallback
# ---------------------------------------------------------------------------


class _FakeLib:
    """Records which entry point a launch calls; returns `rc`."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def __getattr__(self, name):
        if not name.startswith("fq_"):
            raise AttributeError(name)

        def fn(*args):
            self.calls.append(name)
            return self.rc if name != "fq_error_string" else b"fake failure"
        return fn


def _launch(monkeypatch, lib, m, grouped):
    monkeypatch.setattr(common, "lib", lambda stem: lib)
    monkeypatch.setattr(common, "stream_ptr", lambda t: 0)
    k, n = 256, 64
    xq = torch.zeros((k // 128, m, 128) if grouped else (m, k),
                     dtype=torch.int8)
    name = "w4a4_matmul_i8_grouped" if grouped else "w4a4_matmul_i8"
    return name, tmm.launch_w4a4(
        name, xq, torch.ones((m, 1)), torch.zeros((n, k // 2), dtype=torch.uint8),
        torch.ones(n), torch.bfloat16, m, n, k, grouped)


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("m", [4, 2048])
def test_launch_takes_the_picked_entry_point(monkeypatch, grouped, m):
    lib = _FakeLib()
    common.reset_launches()
    name, y = _launch(monkeypatch, lib, m, grouped)
    body = tmm.w4a4_body(m, 64, 256)
    assert lib.calls == [f"fq_w4a4_matmul_i8{'_grouped' * grouped}_{body}"]
    assert y.shape == (m, 64) and y.dtype == torch.bfloat16
    assert common.LAUNCHES[name] == 1
    assert common.BODY_LAUNCHES[name] == {"stream": int(body == "stream"),
                                          "tile": int(body == "tile")}
    common.reset_launches()
    assert common.BODY_LAUNCHES[name] == {"stream": 0, "tile": 0}


def test_failed_tile_launch_raises_without_fallback(monkeypatch):
    lib = _FakeLib(rc=1)
    common.reset_launches()
    with pytest.raises(RuntimeError, match="w4a4_matmul_i8: kernel launch "
                       "failed"):
        _launch(monkeypatch, lib, 2048, False)
    assert lib.calls == ["fq_w4a4_matmul_i8_tile", "fq_error_string"]
    assert common.LAUNCHES["w4a4_matmul_i8"] == 0
