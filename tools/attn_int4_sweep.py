"""Where the time of the int4-cache attention bodies goes, on the card.

Decode (rows 2, 10, 19-21): `decode_attention_int4`,
`paged_decode_attention_int4` and `decode_attention_int4_v1` (the DEQUANT
instance) at chip_smoke.py phase 3b's and 3f's shapes with
kernels/kv_cache.py DECODE_SPAN at 128, 256 and 512 positions a CTA (the
wrappers pass the span to the kernel: no rebuild).

Variants of csrc/kv_cache.cu that each change or drop one stage of the
chunk body (rows 9, 11) or of the decode body's span merge (a dropped
stage gives wrong results and shows its cost), each built with its own
nvcc, all started together, and timed beside the unchanged body through
the port's own launch glue (the wrappers, with `common.lib` pointed at the
variant's library), at phase 3f's chunk shapes (B=1, Sq=256, bf16
queries, pos 768 and 1792 over S=2048) and the decode shapes above at
the committed span.

Usage (on the card, from the repo root): python3 tools/attn_int4_sweep.py
Prints one line per variant and shape, two rounds; the card's name and
power limit first.
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
from flatquant_torch.kernels import kv_cache as kv  # noqa: E402
from flatquant_torch.kernels import paged_kv as pk  # noqa: E402

SPANS = (128, 256, 512)
# variant -> [(text, replacement, times the text is found)] of
# csrc/kv_cache.cu
VARIANTS = {
    "body": [],
    "one warpgroup a block (no tile split)": [
        ("constexpr int CH_WG = 2;", "constexpr int CH_WG = 1;", 1)],
    "p' hi only (no lo P V pass)": [
        ("#pragma unroll\n    for (int kk = 0; kk < 8; ++kk)\n"
         "      Wgmma<128>::mma_tb(o, pl[kk]",
         "#pragma unroll\n    for (int kk = 0; kk < 0; ++kk)\n"
         "      Wgmma<128>::mma_tb(o, pl[kk]", 1)],
    "no P V products": [
        ("#pragma unroll\n    for (int kk = 0; kk < 8; ++kk)\n"
         "      Wgmma<128>::mma_tb(o, pl[kk]",
         "#pragma unroll\n    for (int kk = 0; kk < 0; ++kk)\n"
         "      Wgmma<128>::mma_tb(o, pl[kk]", 1),
        ("#pragma unroll\n    for (int kk = 0; kk < 8; ++kk)\n"
         "      Wgmma<128>::mma_tb(o, ph[kk]",
         "#pragma unroll\n    for (int kk = 0; kk < 0; ++kk)\n"
         "      Wgmma<128>::mma_tb(o, ph[kk]", 1)],
    "no code decode": [
        ("    for (int i = 0; i < TS * 8 / 128; ++i) {",
         "    for (int i = 0; i < 0; ++i) {", 1)],
    # the decode body: the cost of the span merge's stages
    "decode: partials and tickets, no merge": [
        ("  if (!last_s) return;\n", "  return;\n", 1)],
    "decode: at most 64 registers (4 blocks an SM)": [
        ("__global__ void __launch_bounds__(DT)\ndecode_attention_int4_kernel",
         "__global__ void __launch_bounds__(DT, 4)\n"
         "decode_attention_int4_kernel", 1)],
    "decode: every span writes out (no partials, no tickets)": [
        ("  if (nspan == 1) {  // the whole valid length is this span's",
         "  if (true) {", 1)],
}


def build(work):
    """nvcc every chunk variant into work/<i>/; {name: library path}."""
    procs, out = [], {}
    for i, (name, patches) in enumerate(VARIANTS.items()):
        d = Path(work) / str(i)
        shutil.copytree(common.CSRC, d)
        src = (d / "kv_cache.cu").read_text()
        for a, b, times in patches:
            if src.count(a) != times:
                raise SystemExit(f"{name}: patch text found {src.count(a)} "
                                 f"times, not {times}: {a[:60]!r}")
            src = src.replace(a, b)
        (d / "kv_cache.cu").write_text(src)
        so = d / "libkv_cache.so"
        cmd = [common._nvcc(), *common.ARCH_FLAGS, "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-I", str(d), "-o", str(so),
               str(d / "kv_cache.cu")]
        procs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    for name, so, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        out[name] = so
    return out


def load(path):
    so = ctypes.CDLL(str(path))
    for fn, argtypes in common._SIGNATURES["kv_cache"].items():
        f = getattr(so, fn)
        f.argtypes, f.restype = argtypes, ctypes.c_int
    so.fq_error_string.argtypes = [ctypes.c_int]
    so.fq_error_string.restype = ctypes.c_char_p
    return so


def decode_cases(dev, gen):
    """(label, fn, arg sets) at 3b's and 3f's shapes, bf16 queries."""
    S, sm, out = 2048, 1 / math.sqrt(128), []
    for label, B, nh, nkv, valid_l in [
            ("B=1 MHA 32/32 valid 2048", 1, 32, 32, [S]),
            ("B=4 MHA 32/32 main path", 4, 32, 32, [112] * 4),
            ("B=1 GQA 28/4 valid 2048", 1, 28, 4, [S]),
            ("B=4 GQA 28/4 ragged", 4, 28, 4, [S, 0, 1023, 77])]:
        valid = torch.tensor(valid_l, device=dev, dtype=torch.int32)
        caches = [cs._rand_cache(torch, dev, gen, B, nkv, S)
                  for _ in range(cs.copies_for(B * nkv * S * 144))]
        q = torch.randn((B, nh, 128), generator=gen, device=dev).to(
            torch.bfloat16)
        args = [(q, *c, valid, sm) for c in caches]
        out.append((f"row 2 {label}", kv.decode_attention_int4, args))
        if nkv == 4 and B == 1:
            out.append((f"row 19 {label}", kv.decode_attention_int4_v1,
                        args))
    B, bs, mb = 4, 256, S // 256
    states = [cs._paged_pool(torch, dev, gen, B, 32, mb, bs)
              for _ in range(cs.copies_for((1 + B * mb) * 32 * bs * 144))]
    q = torch.randn((B, 32, 128), generator=gen, device=dev).to(
        torch.bfloat16)
    valid = torch.tensor([1, 255, 256, 1000], device=dev, dtype=torch.int32)
    out.append(("row 10 B=4 MHA valid [1, 255, 256, 1000] block 256",
                pk.paged_decode_attention_int4,
                [(q, *pl, t, valid, sm) for pl, t, _ in states]))
    return out


def chunk_cases(dev, gen):
    S, SQ, sm, out = 2048, 256, 1 / math.sqrt(128), []
    for label, nh, nkv, pos_v in [("MHA 32/32 pos 768", 32, 32, 768),
                                  ("MHA 32/32 pos 1792", 32, 32, 1792),
                                  ("GQA 28/4 pos 768", 28, 4, 768)]:
        caches = [cs._rand_cache(torch, dev, gen, 1, nkv, S)
                  for _ in range(cs.copies_for(nkv * S * 144))]
        q = torch.randn((1, SQ, nh, 128), generator=gen, device=dev).to(
            torch.bfloat16)
        pos = torch.tensor([pos_v], device=dev, dtype=torch.int32)
        out.append((f"row 9 Sq=256 {label}", kv.chunk_attention_int4,
                    [(q, *c, pos, sm) for c in caches]))
    states = [cs._paged_pool(torch, dev, gen, 1, 32, S // 256, 256)
              for _ in range(cs.copies_for((1 + S // 256) * 32 * 256 * 144))]
    q = torch.randn((1, SQ, 32, 128), generator=gen, device=dev).to(
        torch.bfloat16)
    pos = torch.tensor([640], device=dev, dtype=torch.int32)
    out.append(("row 11 Sq=256 MHA 32/32 pos 640 block 256",
                pk.paged_chunk_attention_int4,
                [(q, *pl, t, pos, sm) for pl, t, _ in states]))
    return out


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    common.build()
    dec, chk = decode_cases(dev, gen), chunk_cases(dev, gen)
    with tempfile.TemporaryDirectory() as work:
        libs = build(work)
        real, span0 = common.lib, kv.DECODE_SPAN
        for rnd in range(2):  # two rounds: the spread between them
            for span in SPANS:
                kv.DECODE_SPAN = span
                try:
                    for label, fn, args in dec:
                        ms = cs.cuda_ms(torch, fn, args, 60)
                        print(f"round {rnd} span {span} {label}: {ms:.4f} ms",
                              flush=True)
                finally:
                    kv.DECODE_SPAN = span0
            for name, path in libs.items():
                so = load(path)
                common.lib = lambda s, so=so: so if s == "kv_cache" else real(s)
                cases = dec if name.startswith("decode") else chk
                try:
                    for label, fn, args in cases:
                        ms = cs.cuda_ms(torch, fn, args, 40)
                        print(f"round {rnd} {label} {name}: {ms:.4f} ms",
                              flush=True)
                finally:
                    common.lib = real


if __name__ == "__main__":
    main()
