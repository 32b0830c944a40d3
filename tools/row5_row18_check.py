"""A short card check of rows 5 / 23 (left_quant_i8_flat / _grouped) and
row 18 (flash_prefill_attention_kt_i8): build every kernel with ptxas's
report (registers, spills), hold each to its plain version (codes and
scales within kernels/tolerance.py's modes, the grouped twin bit for
bit; the int8 flash within "flash", its prepass bit for bit) at the
prefill's shapes and at edge shapes, and time each at llama-2-7b's
1 x 2048 prefill (row 18 with its prepass alone beside causal SDPA).
The first call after a change to either body; chip_smoke.py phases 3d,
3i and 3j are the full check.

Usage (on the card, from the repo root): python3 tools/row5_row18_check.py
"""
import contextlib
import io
import math
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from flatquant_torch.kernels import common  # noqa: E402
from flatquant_torch.kernels import flat_pipeline as fp  # noqa: E402
from flatquant_torch.kernels import grouped_mlp as gm  # noqa: E402
from flatquant_torch.kernels import prefill_attention as pa  # noqa: E402
from flatquant_torch.kernels.tolerance import (  # noqa: E402
    compare_bf16, compare_codes, compare_scales)

torch.backends.cuda.matmul.allow_tf32 = False
t0 = time.time()
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    common.build(verbose=True)
for line in buf.getvalue().splitlines():
    if any(k in line for k in ("left_quant", "flash_i8", "kv_amax", "kv_codes",
                               "Used", "spill", "error", "warning")):
        print(line[:300])
print("build", time.time() - t0, flush=True)
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
clip = cs._lac_clip(torch, dev)
fails = 0
for T, G in ((2048, 32), (2048, 86), (37, 86), (300, 86), (8, 2), (2047, 128)):
    x = (torch.randn((T, G * 128), generator=gen, device=dev) * 3).to(
        torch.bfloat16)
    x[T // 2] = 0
    for mode in ("identity", "orthogonal"):
        lt = cs._factor(torch, dev, gen, G, mode)
        try:
            q, s = fp.left_quant_i8_flat(lt, x, clip)
            qr, sr = fp.left_quant_i8_flat_ref(lt, x, clip)
            torch.cuda.synchronize()
            d = (q.int() - qr.int()).abs()
            print(f"LQ T={T} G={G} {mode}: code diff max {d.max().item()} "
                  f"frac {(d > 0).float().mean().item():.2e} scale rel "
                  f"{((s - sr).abs() / sr).max().item():.2e}", flush=True)
            compare_codes(q, qr, mode, "lq codes")
            compare_scales(s, sr, mode, "lq scales")
            qg, sg = gm.left_quant_i8_grouped(lt, gm.group_layout(x, G), clip)
            ok = torch.equal(gm.ungroup_layout(qg), q) and torch.equal(sg, s)
            print("   grouped twin bit-identical:", ok)
            fails += not ok
        except Exception as e:  # noqa: BLE001
            fails += 1
            print("LQ FAIL", T, G, mode, repr(e)[:400], flush=True)
    if T == 2048:
        xs = [(torch.randn((T, G * 128), generator=gen, device=dev) * 3).to(
            torch.bfloat16) for _ in range(cs.copies_for(3 * T * G * 128))]
        ms = cs.cuda_ms(torch, lambda a: fp.left_quant_i8_flat(lt, a, clip),
                        [(a,) for a in xs], 40)
        msg = cs.cuda_ms(torch, lambda a: gm.left_quant_i8_grouped(
            lt, a, clip), [(gm.group_layout(a, G),) for a in xs[:4]], 40)
        b = 3 * T * G * 128 / cs.HBM_BYTES_PER_S * 1e3
        print(f"LQ T={T} G={G}: {ms:.4f} ms (grouped {msg:.4f}), bound "
              f"{b:.4f}", flush=True)

sm = 1 / math.sqrt(128)
sdpa = cs._sdpa(torch)
for S, nh, nkv in ((2048, 32, 32), (1152, 32, 32), (2048, 28, 4),
                   (256, 4, 2), (384, 4, 4)):
    q, k, v = (torch.randn((1, S, n, 128), generator=gen, device=dev).to(
        torch.bfloat16) for n in (nh, nkv, nkv))
    kt = k.permute(0, 2, 3, 1)
    k8r, v8r, scr = pa.quantize_kv_i8_ref(kt, v)
    for pv_i8 in (True, False):
        try:
            out, k8, v8t, sc = pa._launch_i8(q, kt, v, sm, pv_i8, pa.K_BLK)
            torch.cuda.synchronize()
            same = torch.equal(k8, k8r) and torch.equal(sc[..., 0], scr[..., 0])
            if pv_i8:
                same = same and torch.equal(v8t, pa.v8t_key_order(v8r)) and \
                    torch.equal(sc[..., 1], scr[..., 1])
            plain = pa.flash_prefill_attention_kt_i8_ref(q, kt, v, sm, pv_i8)
            err = (out.float() - plain.float()).abs().max().item()
            print(f"FI S={S} {nh}/{nkv} pv_i8={pv_i8}: prepass exact {same}, "
                  f"max err {err:.3e}", flush=True)
            compare_bf16(out, plain, "flash", "flash i8")
            fails += not same
        except Exception as e:  # noqa: BLE001
            fails += 1
            print("FI FAIL", S, nh, nkv, pv_i8, repr(e)[:600], flush=True)
            continue
        if S in (2048,) and nh == 32:
            args = [(q, kt, v)]
            ms = cs.cuda_ms(torch, lambda *a: pa.flash_prefill_attention_kt_i8(
                *a, sm, pv_i8), args, 20)
            pre = cs.cuda_ms(torch, lambda a, b: pa.kv_quant_i8_prepass(
                a, b, pv_i8), [(kt, v)], 20)
            lib = cs.cuda_ms(torch, sdpa, [(q, k, v, sm)], 20)
            print(f"FI S={S} {nh}/{nkv} pv_i8={pv_i8}: {ms:.4f} ms (prepass "
                  f"{pre:.4f}), SDPA {lib:.4f}", flush=True)
print("FAILS", fails)
sys.exit(1 if fails else 0)
