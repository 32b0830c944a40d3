"""Where the time of row 4 (rmsnorm_right_flat) goes, on the card.

Builds variants of csrc/flat_pipeline.cu that each drop or change one
stage of the `rmsnorm_right` body (most give wrong results: the stage's
cost is the point), each with its own nvcc, all started together, and
times them beside the unchanged body through the port's own launch glue
(the wrapper, with `common.lib` pointed at the variant's library) at
llama-2-7b's prefill shape (T = 2048, H = 4096), bf16 and float32 x, in
two interleaved rounds.

Usage (on the card, from the repo root): python3 tools/rmsnorm_ablate.py
Prints one line per variant and shape; the card's name and power limit
first.
"""

import ctypes
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

STEPS = "    const int nsteps = (ghi - glo + RN_GPS - 1) / RN_GPS;"
BUILD = ("      for (int idx = tid; idx < ng * RN_ROWS * 16; idx += RN_THREADS)"
         " {\n        const int gi = idx / (RN_ROWS * 16), r = idx / 16 % RN_ROWS;"
         "\n        const int j = idx % 16;")
STORE = ("      for (int idx = tid; idx < ng * RN_ROWS * 16; idx += RN_THREADS)"
         " {\n        const int gi = idx / (RN_ROWS * 16), r = idx / 16 % RN_ROWS;"
         "\n        const int n = idx % 16;")
MMA = "          if (gi < ng)\n            Wgmma<RN_ROWS>::mma("
PASS1 = "      if (r < nr) {\n        const InT* xr = row(r);"
SMAJOR = ("      for (int s = 0; s < 8; ++s) {\n#pragma unroll\n"
          "        for (int gi = 0; gi < RN_GPS; ++gi) {\n"
          "          if (gi < ng)\n")
GMAJOR = ("      for (int gi = 0; gi < RN_GPS; ++gi) {\n#pragma unroll\n"
          "        for (int s = 0; s < 8; ++s) {\n"
          "          if (gi < ng)\n")
TILES = "  for (int tile = blockIdx.x / RN_CL; tile < ntiles;"
R_LOAD = "  for (int i = tid; i < RN_R_BYTES / 16; i += RN_THREADS) {"

# variant -> [(text, replacement)], each text found exactly once
VARIANTS = {
    "body": [],
    "no products": [(MMA, MMA.replace("gi < ng", "gi < 0"))],
    "no xn build": [(BUILD, BUILD.replace("idx < ng", "idx < 0 * ng"))],
    "no stores": [(STORE, STORE.replace("idx < ng", "idx < 0 * ng"))],
    "no pass 1": [(PASS1, PASS1.replace("r < nr", "r < 0"))],
    "products group by group": [(SMAJOR, GMAJOR)],
    "loads and pass 1 only": [(STEPS, STEPS.replace("nsteps = (", "nsteps = 0 * ("))],
    "loads only": [(STEPS, STEPS.replace("nsteps = (", "nsteps = 0 * (")),
                   (PASS1, PASS1.replace("r < nr", "r < 0"))],
    "empty CTAs (launch only)": [
        (TILES, TILES.replace("tile < ntiles", "tile < 0")),
        (R_LOAD, R_LOAD.replace("i < RN_R_BYTES / 16", "i < 0"))],
    "clusters of 4 (32-token tiles)": [
        ("constexpr int RN_CL = 2;", "constexpr int RN_CL = 4;")],
    "1 group a step": [("constexpr int RN_GPS = 2;",
                        "constexpr int RN_GPS = 1;")],
}


def build(work):
    """nvcc every variant into work/<i>/; returns {name: library path}."""
    procs, out = [], {}
    for i, (name, patches) in enumerate(VARIANTS.items()):
        d = Path(work) / str(i)
        shutil.copytree(common.CSRC, d)
        src = (d / "flat_pipeline.cu").read_text()
        for a, b in patches:
            if src.count(a) != 1 or a == b:
                raise SystemExit(f"{name}: patch text found {src.count(a)} "
                                 f"times or left as it is: {a[:60]!r}")
            src = src.replace(a, b)
        (d / "flat_pipeline.cu").write_text(src)
        so = d / "libflat_pipeline.so"
        cmd = [common._nvcc(), *common.ARCH_FLAGS, "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-I", str(d), "-o", str(so),
               str(d / "flat_pipeline.cu")]
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
    for fn, argtypes in common._SIGNATURES["flat_pipeline"].items():
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
        T, H = 2048, 4096
        w = torch.rand((H,), generator=gen, device=dev) + 0.5
        right = cs._factor(torch, dev, gen, 128, "orthogonal").to(
            torch.bfloat16)
        xs = {dt: [(torch.randn((T, H), generator=gen, device=dev) * 2).to(
            dt) for _ in range(cs.copies_for(4 * T * H))]
            for dt in (torch.bfloat16, torch.float32)}
        for rnd in range(2):  # two rounds: the spread between them
            for name, path in libs.items():
                so = load(path)
                common.lib = lambda s, so=so: (
                    so if s == "flat_pipeline" else real(s))
                try:
                    for dt, x in xs.items():
                        ms = cs.cuda_ms(torch, lambda a: fp.rmsnorm_right_flat(
                            a, w, right, 1e-5), [(a,) for a in x], 40)
                        print(f"round {rnd} T={T} H={H} {dt} {name}: "
                              f"{ms:.4f} ms", flush=True)
                finally:
                    common.lib = real


if __name__ == "__main__":
    main()
