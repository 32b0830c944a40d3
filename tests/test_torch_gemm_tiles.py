"""The tensor-core bodies of row 17 (`w4a4_matmul_i8_fusedq`) and row 16
(`fp8_matmul`), on the CPU: the routes between the bodies, the launch
glue of every entry point (arguments, workspace, stream; a failed launch
raises and no other body is tried), fp8_linear's ragged N reaching the
kernel unpadded, and the arithmetic of row 16's device decode on every
e4m3 code against the port's plain decode and JAX's in-kernel decodes.

The CUDA bodies themselves are held to their plain versions on the card
by tests/test_torch_gpu.py and chip_smoke.py (phases 3a, 3h, 3i, 10, 11).
"""

import inspect

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flatquant_tpu.kernels import fp8_matmul as jf8
from flatquant_torch.kernels import common
from flatquant_torch.kernels import fp8_matmul as tf8
from flatquant_torch.kernels import int4_matmul as tmm

torch.set_num_threads(2)

# llama-2-7b's four A4 linears (N, K): row 17's shapes in phases 3a and 11
LLAMA_LINEARS = {"qkv": (12288, 4096), "o": (4096, 4096),
                 "upgate": (22016, 4096), "down": (4096, 11008)}


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


# ---------------------------------------------------------------------------
# the routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("proj", list(LLAMA_LINEARS))
def test_fusedq_route_at_decode_and_prefill(proj):
    """Row 17: the dp4a body at decode (M = 1 to 15) but on qkv from 4
    rows (its 12288 weight rows are one wave of the tile's blocks, where
    phase 3a measured the tile faster at M = 4), the tile from
    TILE_MIN_M rows (phase 11's 4 x 48 prompt: M = 192) as row 1, and
    from 16 rows already for the wide weights (qkv, up||gate: N >= 5120,
    where phase 3a measured the tile faster at M = 16)."""
    n, k = LLAMA_LINEARS[proj]
    assert (tmm.TILE_MIN_M, tmm.FUSEDQ_WIDE_MIN_M,
            tmm.FUSEDQ_WAVE_MIN_M) == (32, 16, 4)
    wide = "tile" if n >= tmm.FUSEDQ_WIDE_N else "stream"
    wave = "tile" if proj == "qkv" else "stream"
    got = [tmm.fusedq_body(m, n, k)
           for m in (1, 3, 4, 15, 16, 31, 32, 192, 2048)]
    assert got == ["stream", "stream", wave, wave, wide, wide, "tile",
                   "tile", "tile"]
    assert wide == ("tile" if proj in ("qkv", "upgate") else "stream")


@pytest.mark.parametrize("n,body", [(4096, "stream"),
                                    (tmm.FUSEDQ_WAVE_N[0] - 1, "stream"),
                                    (tmm.FUSEDQ_WAVE_N[0], "tile"),
                                    (tmm.FUSEDQ_WAVE_N[1], "tile"),
                                    (tmm.FUSEDQ_WAVE_N[1] + 1, "stream"),
                                    (22016, "stream")])
def test_fusedq_route_at_m4_by_width(n, body):
    """From FUSEDQ_WAVE_MIN_M = 4 rows the tile for a weight of 12288 rows
    up to one wave of 128-row blocks on 132 SMs (phase 3a times both
    bodies at M = 4 on 4096, 12288 and 22016 rows); three rows take the
    dp4a body everywhere."""
    assert tmm.FUSEDQ_WAVE_N == (12288, 16896)
    assert tmm.fusedq_body(4, n, 4096) == body
    assert tmm.fusedq_body(3, n, 4096) == "stream"


@pytest.mark.parametrize("n,body", [(4096, "stream"),
                                    (tmm.FUSEDQ_WIDE_N - 1, "stream"),
                                    (tmm.FUSEDQ_WIDE_N, "tile"),
                                    (8192, "tile")])
def test_fusedq_route_at_m16_by_width(n, body):
    """At FUSEDQ_WIDE_MIN_M = 16 rows the tile from FUSEDQ_WIDE_N = 5120
    weight rows on (phase 3a times both bodies at N = 5120 to 10240);
    one row fewer takes the dp4a body everywhere."""
    assert tmm.FUSEDQ_WIDE_N == 5120
    assert tmm.fusedq_body(16, n, 4096) == body
    assert tmm.fusedq_body(15, n, 4096) == "stream"


@pytest.mark.parametrize("k", [tmm.TILE_MAX_K, 2 * tmm.TILE_MAX_K])
def test_fusedq_route_past_tile_max_k(k):
    """At K >= TILE_MAX_K the tile's int32 sums could wrap: the dp4a body
    at every M."""
    assert [tmm.fusedq_body(m, 4096, k) for m in (1, 32, 2048)] == \
        ["stream"] * 3


@pytest.mark.parametrize("m,body", [(1, "n8"), (4, "n8"), (8, "n8"),
                                    (9, "n64"), (64, "n64"), (65, "n128"),
                                    (384, "n128"), (2048, "n128")])
def test_fp8_route_by_tokens(m, body):
    assert tf8.fp8_body(m) == body


# ---------------------------------------------------------------------------
# launch glue
# ---------------------------------------------------------------------------


def _fusedq_launch(m, n=64, k=256, x_dtype=torch.bfloat16,
                   out=torch.float32):
    x = torch.zeros((m, k), dtype=x_dtype)
    return tmm.launch_fusedq(x, torch.ones(2), torch.zeros(
        (n, k // 2), dtype=torch.uint8), torch.ones(n), out, m, n, k)


@pytest.mark.parametrize("m", [4, 300])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_fusedq_launch_takes_the_picked_entry_point(fake, m, x_dtype):
    lib = fake()
    y = _fusedq_launch(m, x_dtype=x_dtype)
    body = tmm.fusedq_body(m, 64, 256)
    (name, args), = lib.calls
    assert name == f"fq_w4a4_matmul_i8_fusedq_{body}"
    # ..., M, N, K, x_is_f32, out_is_f32, stream
    assert args[-6:] == (m, 64, 256, int(x_dtype == torch.float32), 1, 1234)
    assert len(args) == (14 if body == "tile" else 11)
    assert y.shape == (m, 64) and y.dtype == torch.float32
    assert common.LAUNCHES["w4a4_matmul_i8_fusedq"] == 1
    assert common.BODY_LAUNCHES["w4a4_matmul_i8_fusedq"] == {
        "stream": int(body == "stream"), "tile": int(body == "tile")}


@pytest.mark.parametrize("m,tiles", [(32, 1), (128, 1), (129, 2), (300, 3),
                                     (2048, 16)])
def test_fusedq_workspace(m, tiles):
    """The tile body's workspace: codes [M, K] int8, scales [M] float32,
    and a ticket and a done count per 128-row M tile, zeroed."""
    xq, xs, flags = tmm.fusedq_workspace(m, 2848, "cpu")
    assert xq.shape == (m, 2848) and xq.dtype == torch.int8
    assert xs.shape == (m,) and xs.dtype == torch.float32
    assert flags.shape == (2 * tiles,) and flags.dtype == torch.int32
    assert not flags.any()


@pytest.mark.parametrize("m", [4, 300])
def test_fusedq_failed_launch_raises_without_fallback(fake, m):
    lib = fake(rc=1)
    with pytest.raises(RuntimeError, match="w4a4_matmul_i8_fusedq: kernel "
                       "launch failed"):
        _fusedq_launch(m)
    body = tmm.fusedq_body(m, 64, 256)
    assert [c[0] for c in lib.calls] == [
        f"fq_w4a4_matmul_i8_fusedq_{body}", "fq_error_string"]
    assert common.LAUNCHES["w4a4_matmul_i8_fusedq"] == 0


def _fp8_launch(m, e=None, n=576, k=256, exact=True, out=torch.bfloat16):
    lead = (e,) if e else ()
    x = torch.zeros(lead + (m, k), dtype=torch.bfloat16)
    w8 = torch.zeros(lead + (n, k)).to(torch.float8_e4m3fn)
    se = torch.ones(lead + (k // 128, n))
    return tf8.launch_fp8(x, m * k if e else 0, w8, se, out, exact, e, m, n,
                          k)


@pytest.mark.parametrize("m", [1, 64, 65])
@pytest.mark.parametrize("e", [None, 3])
def test_fp8_launch_takes_the_picked_entry_point(fake, m, e):
    lib = fake()
    y = _fp8_launch(m, e, exact=False, out=torch.float32)
    body = tf8.fp8_body(m)
    (name, args), = lib.calls
    assert name == f"fq_fp8_matmul_{body}"
    # x, x_estride, w8, se, y, E, M, N, K, exact, out_is_f32, stream
    assert args[1] == (m * 256 if e else 0)
    assert args[5:] == (e or 1, m, 576, 256, 0, 1, 1234)
    assert y.shape == ((e,) if e else ()) + (m, 576)
    assert common.LAUNCHES["fp8_matmul"] == 1
    assert common.BODY_LAUNCHES["fp8_matmul"] == {
        b: int(b == body) for b in ("n8", "n64", "n128")}


@pytest.mark.parametrize("m", [1, 64, 65])
def test_fp8_failed_launch_raises_without_fallback(fake, m):
    lib = fake(rc=1)
    with pytest.raises(RuntimeError, match="fp8_matmul: kernel launch "
                       "failed"):
        _fp8_launch(m)
    assert [c[0] for c in lib.calls] == [
        f"fq_fp8_matmul_{tf8.fp8_body(m)}", "fq_error_string"]
    assert common.LAUNCHES["fp8_matmul"] == 0


@pytest.mark.parametrize("fn", ["fp8_matmul", "fp8_linear"])
def test_fp8_exact_default_matches_jax(fn):
    """fp8_matmul and fp8_linear decode as JAX's do by default: the
    flush-to-zero decode (exact=False); the port defaulted to the exact
    decode until the fault was fixed."""
    want = inspect.signature(getattr(jf8, fn)).parameters["exact"].default
    assert want is False
    assert inspect.signature(getattr(tf8, fn)).parameters["exact"].default \
        is want


def test_fp8_default_call_flushes_subnormal_codes_as_jax():
    """A call with the defaults on weights that hold subnormal codes: the
    port (its plain version, the kernel's decode) equals JAX's kernel
    called with its defaults (interpret mode), and both zero exactly the
    subnormal codes."""
    codes = np.tile(np.arange(256, dtype=np.uint8), 64).reshape(128, 128)
    codes[(codes & 0x7F) == 0x7F] = 0
    x = np.eye(128, dtype=np.float32)
    w8 = torch.from_numpy(codes).view(torch.float8_e4m3fn)
    want = np.asarray(jf8.fp8_matmul(
        jnp.asarray(x, jnp.bfloat16),
        jax.lax.bitcast_convert_type(jnp.asarray(codes), jnp.float8_e4m3fn),
        jnp.ones((1, 128), jnp.float32), out_dtype=jnp.float32,
        interpret=True))
    got = tf8.fp8_matmul(torch.from_numpy(x).to(torch.bfloat16), w8,
                         torch.ones(1, 128), torch.float32).numpy()
    np.testing.assert_array_equal(got, want)
    sub = ((codes.T & 0x7F) > 0) & ((codes.T & 0x7F) < 8)
    assert sub.any() and (got[sub] == 0).all()
    lin = {"w8": w8, "se": torch.ones(1, 128)}
    got_lin = tf8.fp8_linear(torch.from_numpy(x).to(torch.bfloat16), lin,
                             out_dtype=torch.float32,
                             use_kernel=True).numpy()
    np.testing.assert_array_equal(got_lin, want)


def test_fp8_linear_defaults_match_jax_on_every_code():
    """fp8_linear with every default on a CPU tensor takes JAX's route
    for its defaults off the accelerator: fp8_matmul_ref with the exact
    decode, so subnormal codes keep their values (the port took its
    kernel route there, and zeroed them, until the fault was fixed: 896
    of 16,384 outputs, by up to 7 * 2**-9)."""
    assert inspect.signature(tf8.fp8_linear).parameters[
        "use_kernel"].default is inspect.signature(jf8.fp8_linear
                                                   ).parameters[
        "use_kernel"].default is None
    codes = np.tile(np.arange(256, dtype=np.uint8), 64).reshape(128, 128)
    codes[(codes & 0x7F) == 0x7F] = 0
    x = np.eye(128, dtype=np.float32)
    jlin = {"w8": jax.lax.bitcast_convert_type(jnp.asarray(codes),
                                               jnp.float8_e4m3fn),
            "se": jnp.ones((1, 128), jnp.float32)}
    want = np.asarray(jf8.fp8_linear(jnp.asarray(x, jnp.bfloat16), jlin,
                                     out_dtype=jnp.float32))
    lin = {"w8": torch.from_numpy(codes).view(torch.float8_e4m3fn),
           "se": torch.ones(1, 128)}
    got = tf8.fp8_linear(torch.from_numpy(x).to(torch.bfloat16), lin,
                         out_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(got, want)
    sub = ((codes.T & 0x7F) > 0) & ((codes.T & 0x7F) < 8)
    assert sub.sum() == 896 and (got[sub] != 0).all()


def test_fp8_linear_hands_the_kernel_a_ragged_n_unpadded(monkeypatch):
    """DeepSeek-V3's wkv_a (N = 576, K = 7168) in 128-blocks: fp8_linear
    calls the kernel on the weight and scales as they are (no pad copy)
    and returns its output uncut."""
    rng = np.random.default_rng(0)
    n, k = 576, 7168
    w8, s = tf8.fp8_block_quantize(torch.from_numpy(
        rng.normal(size=(n, k)).astype(np.float32) * 0.05), 128)
    lin = {"w8": w8, "se": tf8.expand_fp8_scales(s, n, k)}
    x = torch.from_numpy(rng.normal(size=(2, 3, k)).astype(np.float32)).to(
        torch.bfloat16)
    seen, kernel = [], tf8.fp8_matmul
    monkeypatch.setattr(tf8, "fp8_matmul", lambda x_, w_, s_, *a: (
        seen.append((w_, s_, tuple(x_.shape))) or kernel(x_, w_, s_, *a)))
    got = tf8.fp8_linear(x, lin, use_kernel=True)
    (w_, s_, xshape), = seen
    assert w_ is w8 and s_ is lin["se"] and xshape == (6, k)
    assert got.shape == (2, 3, n)
    want = tf8.fp8_matmul_ref(x.reshape(-1, k), w8, lin["se"], x.dtype)
    assert torch.equal(got.reshape(-1, n), want)


# ---------------------------------------------------------------------------
# row 16's device decode, on every code
# ---------------------------------------------------------------------------


def _byte_perm_sign(v, sel):
    """PTX prmt.b32 (v, 0, sel) in its default mode on uint32 words
    (numpy): result byte i is byte sel_i & 7 of (v, 0), or, where sel_i &
    8, that byte's sign bit replicated over the byte."""
    src = np.stack([(v >> np.uint32(8 * i)) & np.uint32(0xFF)
                    for i in range(4)] + [np.zeros_like(v)] * 4)
    out = np.zeros_like(v)
    for i in range(4):
        nib = (sel >> (4 * i)) & 0xF
        b = src[nib & 7]
        if nib & 8:
            b = np.where(b & np.uint32(0x80), np.uint32(0xFF), np.uint32(0))
        out |= b << np.uint32(8 * i)
    return out


def decode2_emulation(codes, exact):
    """csrc/fp8_matmul.cu decode2 on pairs of codes, numpy: the byte
    permute, shift and mask to bf16 bits, the flush of exponent field 0
    (FTZ), then the bf16 value times 2^120 (exact, so computed in float64)
    -> float64 values of every code."""
    c = codes.astype(np.uint32)
    v = c[0::2] | (c[1::2] << np.uint32(8))  # two codes a word
    t = (_byte_perm_sign(v, 0x9180) << np.uint32(4)) & np.uint32(0x87F087F0)
    if not exact:
        f = ((t & np.uint32(0x07800780)) + np.uint32(0x7F807F80)) \
            & np.uint32(0x80008000)
        t &= _byte_perm_sign(f, 0xBB99)
    halves = np.stack([t & np.uint32(0xFFFF), t >> np.uint32(16)], 1)
    bf16 = (halves.reshape(-1) << np.uint32(16)).view(np.float32)
    return bf16.astype(np.float64) * 2.0 ** 120


@pytest.mark.parametrize("exact", [True, False])
def test_device_decode_on_all_codes(exact):
    """Every e4m3 code: the device formula equals JAX's in-kernel decode
    (`_decode_exact` / `_decode_ftz`, the NaN codes at +-480) on all 256
    codes, and the port's plain decode (`decode_e4m3`) on the 254 others,
    bit for bit (signs of zero included: -0 survives only the exact
    decode)."""
    codes = np.arange(256, dtype=np.uint8)
    got = decode2_emulation(codes, exact)
    jdec = jf8._decode_exact if exact else jf8._decode_ftz
    want = np.asarray(jdec(jnp.asarray(codes, jnp.int32)), np.float64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
    plain = tf8.decode_e4m3(torch.from_numpy(codes).view(torch.float8_e4m3fn),
                            exact).double().numpy()
    ok = (codes & 0x7F) != 0x7F
    np.testing.assert_array_equal(got[ok], plain[ok])
    np.testing.assert_array_equal(got[~ok], [480.0, -480.0])
    assert np.signbit(got[0x80]) == exact
