"""Where the time of rows 5 and 18 goes, on the card.

Builds variants of csrc/flat_pipeline.cu (left_quant_i8_flat, row 5) and
csrc/flash_prefill_i8.cu (flash_prefill_attention_kt_i8, row 18) that
each drop or change one stage of the body (wrong results, the stage's
cost), each with its own nvcc, all started together, and times them
beside the unchanged body through the port's own launch glue (the
wrappers, with `common.lib` pointed at the variant's library): row 5 at
llama-2-7b's 1 x 2048 prefill (T = 2048, K = 4096 and 11008), row 18 at
B = 1, S = 2048, 32/32 heads in both pv_i8 modes.

Usage (on the card, from the repo root): python3 tools/row5_row18_ablate.py
Prints one line per variant and shape; the card's name and power limit
first.
"""

import ctypes
import math
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from flatquant_torch.kernels import common  # noqa: E402
from flatquant_torch.kernels import flat_pipeline as fp  # noqa: E402
from flatquant_torch.kernels import prefill_attention as pa  # noqa: E402

# (source, variant) -> [(text, replacement)], each text found exactly once
VARIANTS = {
    "flat_pipeline": {
        "body": [],
        "no codes (phase 2)": [
            ("for (int c = wt; c < G * 16; c += 128) {",
             "for (int c = wt; c < 0; c += 128) {")],
        "no z, no codes (phases 1, 2)": [
            ("for (int c = wt; c < G * 16; c += 128) {",
             "for (int c = wt; c < 0; c += 128) {"),
            ("        if (i < G) {\n          uint8_t* row = z_s",
             "        if (i < 0) {\n          uint8_t* row = z_s")],
        "loads and stores only": [
            ("for (int c = wt; c < G * 16; c += 128) {",
             "for (int c = wt; c < 0; c += 128) {"),
            ("        if (i < G) {\n          uint8_t* row = z_s",
             "        if (i < 0) {\n          uint8_t* row = z_s"),
            ("        if (kk < nk)\n", "        if (kk < 0)\n")],
        "codes without the near-half check": [
            ("        near_half |= fabsf(__fsub_rn(qf, __fsub_rn(y, RINT_MAGIC))) "
             "> 0.4999f;\n", "")],
        "codes by rintf(z / s) alone": [
            ("        q[e] = __float_as_int(y) - RINT_MAGIC_BITS;\n",
             "        q[e] = static_cast<int>(fminf(fmaxf(rintf(f[e] / sc), "
             "lo_q), q_max)) + 0 * __float_as_int(y);\n"),
            ("        near_half |= fabsf(__fsub_rn(qf, __fsub_rn(y, RINT_MAGIC))) "
             "> 0.4999f;\n", "")],
        "8 slab stages at most": [
            ("constexpr int LQ_MAX_STAGES = 16;", "constexpr int LQ_MAX_STAGES = 8;")],
    },
    "flash_prefill_i8": {
        "body": [],
        "sums to float through 1.5 * 2^23": [
            ("float x0 = __fmul_rn(static_cast<float>(si[i]), ss);",
             "float x0 = __fmul_rn(__fsub_rn(__int_as_float(si[i] + "
             "RINT_MAGIC_BITS), RINT_MAGIC), ss);"),
            ("float x1 = __fmul_rn(static_cast<float>(si[i + 1]), ss);",
             "float x1 = __fmul_rn(__fsub_rn(__int_as_float(si[i + 1] + "
             "RINT_MAGIC_BITS), RINT_MAGIC), ss);")],
        "codes by __float2int_rn": [
            ("      __float_as_int(__fadd_rn(x, RINT_MAGIC)) - RINT_MAGIC_BITS);",
             "      __float2int_rn(x));")],
        "no exp2": [
            ("const float p0 = exp2f(__fsub_rn(x0, m));",
             "const float p0 = __fsub_rn(x0, m);"),
            ("const float p1 = exp2f(__fsub_rn(x1, m));",
             "const float p1 = __fsub_rn(x1, m);")],
        "no P V products": [
            ("          wgmma_s8_rs_n128(pvi, pa[k2], sw128_desc(vt + k2 * 32),\n"
             "                           t > 0 || k2 > 0);", ";"),
            ("          Wgmma<128>::mma_tb(o, pa[kk],\n"
             "                             sw128_mn_desc(vt + kk * 2048, "
             "FI_BK * 128), 1);", ";")],
    },
}


def build(work):
    """nvcc every variant into work/<stem>-<i>/; returns {(stem, name):
    path of the library}."""
    csrc = Path(common.CSRC)
    procs, out = [], {}
    for stem, variants in VARIANTS.items():
        for i, (name, patches) in enumerate(variants.items()):
            d = Path(work) / f"{stem}-{i}"
            shutil.copytree(csrc, d)
            src = (d / f"{stem}.cu").read_text()
            for a, b in patches:
                if src.count(a) != 1:
                    raise SystemExit(f"{stem} / {name}: patch text found "
                                     f"{src.count(a)} times: {a[:60]!r}")
                src = src.replace(a, b)
            (d / f"{stem}.cu").write_text(src)
            so = d / f"lib{stem}.so"
            cmd = [common._nvcc(), *common.ARCH_FLAGS, "-std=c++17", "-O3",
                   "-shared", "-Xcompiler", "-fPIC", "-I", str(d), "-o",
                   str(so), str(d / f"{stem}.cu")]
            procs.append((stem, name, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for stem, name, so, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{stem} / {name}: nvcc failed\n{log}")
        out[(stem, name)] = so
    return out


def load(stem, path):
    so = ctypes.CDLL(str(path))
    for fn, argtypes in common._SIGNATURES[stem].items():
        f = getattr(so, fn)
        f.argtypes, f.restype = argtypes, ctypes.c_int
    so.fq_error_string.argtypes = [ctypes.c_int]
    so.fq_error_string.restype = ctypes.c_char_p
    return so


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    with tempfile.TemporaryDirectory() as work:
        libs = build(work)
        real = common.lib
        clip = cs._lac_clip(torch, dev)
        T = 2048
        lq = {}
        for g in (32, 86):
            lt = cs._factor(torch, dev, gen, g, "orthogonal")
            xs = [(torch.randn((T, g * 128), generator=gen, device=dev)
                   * 3).to(torch.bfloat16)
                  for _ in range(cs.copies_for(3 * T * g * 128))]
            lq[g] = (lt, xs)
        sm = 1 / math.sqrt(128)
        q, k, v = (torch.randn((1, 2048, 32, 128), generator=gen,
                               device=dev).to(torch.bfloat16)
                   for _ in range(3))
        kt = k.permute(0, 2, 3, 1)
        for rnd in range(2):  # two rounds: the spread between them
            for (stem, name), path in libs.items():
                so = load(stem, path)
                common.lib = lambda s, so=so, stem=stem: (
                    so if s == stem else real(s))
                try:
                    if stem == "flat_pipeline":
                        for g, (lt, xs) in lq.items():
                            ms = cs.cuda_ms(torch, lambda a: (
                                fp.left_quant_i8_flat(lt, a, clip)),
                                [(a,) for a in xs], 40)
                            print(f"round {rnd} row 5 K={g * 128} {name}: "
                                  f"{ms:.4f} ms", flush=True)
                    else:
                        for pv_i8 in (True, False):
                            ms = cs.cuda_ms(torch, lambda: pa._launch_i8(
                                q, kt, v, sm, pv_i8, pa.K_BLK), [()], 20)
                            print(f"round {rnd} row 18 pv_i8={pv_i8} "
                                  f"{name}: {ms:.4f} ms", flush=True)
                finally:
                    common.lib = real


if __name__ == "__main__":
    main()
