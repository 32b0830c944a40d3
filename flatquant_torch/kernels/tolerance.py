"""How a prefill kernel is held to its plain version on the card.

A kernel may sum a bf16 product in another order than its plain version;
that moves a bf16 output by an ulp now and then, and a moved value can
move an int4 code or a per-token scale. So each kernel of the fused
prefill is checked twice (chip_smoke.py phases 3d, 5 and 6,
tests/test_torch_gpu.py):

  "identity"   identity transform factors: no float product is
               reordered, so codes, scales and KV params must be
               bit-exact and bf16 outputs within one ulp;
  "orthogonal" random orthogonal factors: the tolerances the JAX
               package's own tests use for the same functions
               (tests/test_flat_pipeline.py): codes within 2 on < 3% of
               them, zero points within 1, scales within 2 bf16 ulps
               (relative 2^-7; a scale follows the row's largest value,
               itself a bf16 rounding), bf16 outputs within 2 ulps.

An ulp of a bf16 output is taken at the larger of the value and 1/256 of
the largest value in its row: a float32 sum's rounding error follows the
magnitude of its terms, so an output that cancels to near zero carries an
error of the row's scale, not of its own. With orthogonal factors, a
bf16 value rounded before a product (RMSNorm's normalized row, the swiglu
activation, RoPE's output) may itself round one ulp apart, and that ulp
reaches every output of its 128-column group through the product: so up
to 1 in 10^4 outputs may miss the 2-ulp bound as long as every output
stays within 2 ulps of its row's largest value.

The flash attention kernel has a mode of its own (chip_smoke.py phases 3e
and 6, tests/test_torch_gpu.py):

  "flash"      the flash attention kernel (kernels/prefill_attention.py):
               p = exp2(s - m) is rounded to bf16 before the PV product at
               the running row max m, which the kernel takes over tiles of
               128 keys and the plain version (JAX's blocking) over blocks
               of 512, so nearly every p rounds apart by up to 2^-9 of
               itself. An output moves by a signed sum of those roundings
               over its row's keys, of the order of 2^-9 of the values of
               V it averages, whatever its own size: every output within 2
               bf16 ulps of the largest value of its (token, head) row.

The int8 flash attention (flash_prefill_attention_kt_i8) keeps the plain
version's key blocks and rounding points, and on the card kernel and
plain version take the same exp2f: its p, codes and int32 sums are the
plain version's, and only the float32 sums of l (and of p.V without
pv_i8) run in another order. So on the card (chip_smoke.py phases 3i and
11, tests/test_torch_gpu.py) it is held to the "flash" mode. Against the
JAX package on the CPU (tests/test_torch_baselines.py) XLA's exp2 and
torch's differ by an ulp on most inputs, and a p * 127 that lies at a
rounding tie then takes the other int8 code, which moves an output by
|v| / (127 l) for a row whose softmax sums to l >= 1. compare_flash_i8
holds that parity to the "flash" bound plus one int8 code of V at l = 1
(the head's max|V| / 127): the "flash_i8" bound, for the CPU only.

The fp8 GEMM (kernels/fp8_matmul.py, chip_smoke.py phases 3h and 10,
tests/test_torch_gpu.py) decodes every code exactly and multiplies exact
bf16 values, so kernel and plain version differ only in the order of
their float32 sums (the tensor cores' within a 128-k chunk; the chunks
are added in the same order): float32 outputs within FP8_F32_TOL, the
JAX package's own bound for its kernel against its reference
(tests/test_fp8_gemm.py), and bf16 outputs within the "identity" mode's
one ulp. Decoding alone (an identity x) is exact.
"""

from __future__ import annotations

import torch

MODES = {
    "identity": dict(ulps=1, row_floor=1 / 256, outlier_frac=0.0,
                     code_diff=0, code_frac=0.0, scale_rtol=0.0, zero_diff=0),
    "orthogonal": dict(ulps=2, row_floor=1 / 256, outlier_frac=1e-4,
                       code_diff=2, code_frac=0.03, scale_rtol=2.0 ** -7,
                       zero_diff=1),
    "flash": dict(ulps=2, row_floor=1.0, outlier_frac=0.0),
}


FP8_F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _fail(what, msg):
    raise AssertionError(f"{what}: {msg}")


def bf16_ulp(v):
    """Spacing of bf16 numbers at |v| (float32 tensor)."""
    _, e = torch.frexp(v.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(v), e - 8)


def compare_bf16(got, want, mode, what):
    """bf16 outputs within MODES[mode] (see the module note). Returns the
    max abs error."""
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        _fail(what, f"shape {tuple(g.shape)} != {tuple(w.shape)}")
    m = MODES[mode]
    rowmax = w.abs().amax(dim=-1, keepdim=True)
    lim = m["ulps"] * bf16_ulp(torch.maximum(w.abs(),
                                             rowmax * m["row_floor"]))
    err = (g - w).abs()
    bad = err > lim
    frac = bad.double().mean().item()
    worst = (err > m["ulps"] * bf16_ulp(rowmax)).any().item()
    if not torch.isfinite(g).all() or frac > m["outlier_frac"] or worst:
        _fail(what, f"{int(bad.sum())} of {bad.numel()} values beyond "
              f"{m['ulps']} bf16 ulp(s) ({mode} factors allow "
              f"{m['outlier_frac']:g} of them), max abs err "
              f"{err.max().item():.3e}")
    return err.max().item()


def compare_flash_i8(got, want, v, what):
    """flash_prefill_attention_kt_i8's outputs [B, S, nh, hd] against the
    JAX package's on the CPU: within 2 bf16 ulps of their (token, head)
    row's largest value plus one int8 code of V, the head's max|V| / 127
    (the module note); v [B, S, nkv, hd] is the attention's V. Returns the
    max abs error."""
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        _fail(what, f"shape {tuple(g.shape)} != {tuple(w.shape)}")
    nh, nkv = g.shape[2], v.shape[2]
    vcode = (v.float().abs().amax(dim=(1, 3)) / 127.0).repeat_interleave(
        nh // nkv, dim=1)[:, None, :, None]
    lim = 2 * bf16_ulp(w.abs().amax(dim=-1, keepdim=True)) + vcode
    err = (g - w).abs()
    bad = ~(err <= lim)
    if bad.any():
        _fail(what, f"{int(bad.sum())} of {bad.numel()} values beyond 2 "
              f"bf16 ulps of their row's largest value plus one V code, "
              f"max abs err {err.max().item():.3e}")
    return err.max().item()


def _nibbles(codes):
    c = codes.to(torch.int32)
    return torch.cat([c & 0xF, c >> 4], dim=-1)


def compare_codes(got, want, mode, what, packed=False):
    """int codes (packed=True: planar uint8 nibble pairs) within
    MODES[mode]['code_diff'] on at most code_frac of them."""
    g = _nibbles(got) if packed else got.to(torch.int32)
    w = _nibbles(want) if packed else want.to(torch.int32)
    d = (g - w).abs()
    frac = (d > 0).double().mean().item()
    m = MODES[mode]
    if d.max().item() > m["code_diff"] or frac > m["code_frac"]:
        _fail(what, f"codes differ by up to {d.max().item()} on {frac:.4%} "
              f"({mode} factors allow {m['code_diff']} on "
              f"{m['code_frac']:.0%})")
    return float(d.max().item())


def compare_scales(got, want, mode, what):
    """float32 scales within MODES[mode]['scale_rtol'] (0: bit-exact).
    Returns the max abs error."""
    rtol = MODES[mode]["scale_rtol"]
    err = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
    if (rtol == 0 and not torch.equal(got, want)) or err > rtol:
        _fail(what, f"scales differ, max relative err {err:.3e} ({mode} "
              f"factors allow {rtol})")
    return (got - want).abs().max().item()


def compare_kv(codes, params, codes_ref, params_ref, mode, what):
    """Packed asym-int4 KV codes and (scale, zero) params. Returns the max
    abs error of the scales."""
    compare_codes(codes, codes_ref, mode, what + " codes", packed=True)
    err = compare_scales(params[..., 0], params_ref[..., 0], mode,
                         what + " scales")
    dz = (params[..., 1] - params_ref[..., 1]).abs().max().item()
    if dz > MODES[mode]["zero_diff"]:
        _fail(what, f"zero points differ by {dz} ({mode} factors)")
    return err


def compare_f32(got, want, what, rtol=FP8_F32_TOL["rtol"],
                atol=FP8_F32_TOL["atol"]):
    """float32 outputs: |got - want| <= atol + rtol * |want| everywhere.
    Returns the max abs error."""
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        _fail(what, f"shape {tuple(g.shape)} != {tuple(w.shape)}")
    err = (g - w).abs()
    bad = ~(err <= atol + rtol * w.abs())
    if bad.any():
        _fail(what, f"{int(bad.sum())} of {bad.numel()} values beyond rtol "
              f"{rtol:g} / atol {atol:g}, max abs err {err.max().item():.3e}")
    return err.max().item()
