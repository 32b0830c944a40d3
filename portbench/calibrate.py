"""Readings that set a cell's limits on `correct` (not run by the
benchmark's own runs):

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 12 [--faults a,b] [--control-seeds 1,2] --out <file.jsonl>

For each seed, in one process: the cell's set-up and a window at its own
load, then the numbers that run.py compares (check.numbers: the mean and
widest gap by which a served token's logit lies below the reference's
best, and the served token's logit error over the spread of the
reference's logits) against the plain reference at each precision of
--precisions: the program's reading. With a seed of --control-seeds, the
control's too: the reference computed with every tensor the program holds
in bf16 rounded to float8 e4m3 instead, read at the same positions (the
token it puts first, and its logit there). With --faults, each named
fault of harness/faults.py is planted in its own run of each seed: a
fault's reading. One JSON line per run; then a summary per precision and
number: "lower", the largest program reading; "upper", the smallest
control reading; and the smallest reading of each fault.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench import run  # noqa: E402
from portbench.harness import catalog, check  # noqa: E402
from portbench.reference.common import (  # noqa: E402
    PRECISIONS,
    fp8_e4m3,
    restore_matmul,
    set_exact_matmul,
)

NUMBERS = ("mean_gap", "widest_gap", "logit_error")


def reading(cell, seed, seconds, dev, family, reference, control=True,
            fault=None, precisions=("float32", "bf16")):
    t = time.perf_counter()
    with torch.no_grad():
        win, _, _, _ = run.serve_cell(cell, seed, seconds, dev, False,
                                      family, fault)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    picks = check.sample(win["done"], seed, cell["check"]["served_tokens"])
    seqs = check.sequences(picks)
    toks = [r.req.out_tokens for r in picks]
    vals = check.served_logits(picks, win["tapped"])
    out = {"seed": seed, "fault": fault, "weights": cell["cfg"]["weights"],
           "requests": len(picks),
           "program": {}, "control": {}}
    prev = set_exact_matmul()
    try:
        low = None
        if control:
            low = reference.logits(cell["cfg"], seed, seqs, dev,
                                   rnd=fp8_e4m3)
            c_toks = [lg.argmax(dim=-1).cpu().numpy() for lg in low]
            c_vals = [lg.amax(dim=-1).cpu().numpy() for lg in low]
            del low
        for p in precisions:
            ref = reference.logits(cell["cfg"], seed, seqs, dev,
                                   rnd=PRECISIONS[p])
            out["program"][p] = check.numbers(ref, toks, vals)
            if control:
                out["control"][p] = check.numbers(ref, c_toks, c_vals)
            del ref
    finally:
        restore_matmul(prev)
    out["seconds"] = time.perf_counter() - t
    return out


def summary(rows: list, precisions) -> dict:
    """Per precision and number: the largest program reading ("lower"),
    the smallest control reading ("upper"), the smallest of each fault."""
    out = {}
    for p in precisions:
        for n in NUMBERS:
            prog = [r["program"][p][n] for r in rows if r["fault"] is None]
            ctl = [r["control"][p][n] for r in rows if r["control"]]
            s = {"lower": max(prog) if prog else None,
                 "upper": min(ctl) if ctl else None}
            for f in sorted({r["fault"] for r in rows} - {None}):
                s[f] = min(r["program"][p][n] for r in rows
                           if r["fault"] == f)
            out[f"{p}.{n}"] = s
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control-seeds", default="",
                   help="seeds whose reading also reads the control")
    p.add_argument("--faults", default="",
                   help="faults of harness/faults.py, each planted in a "
                   "run of every seed")
    p.add_argument("--fault-seeds", default="",
                   help="the seeds the faults run on (default: --seeds)")
    p.add_argument("--precisions", default="float32,bf16")
    p.add_argument("--weights", default="",
                   help="key=value,...: stand-in scales to try in place of "
                   "the configuration's (its \"weights\")")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--out")
    a = p.parse_args(argv)
    cell = catalog.cell(a.workload)
    for kv in filter(None, a.weights.split(",")):
        key, val = kv.split("=")
        cell["cfg"]["weights"][key] = float(val)
    dev = torch.device("cuda", 0) if a.device == "cuda" else \
        torch.device("cpu")
    torch.set_num_threads(1)
    family = catalog.load_module("families", cell["cfg"]["family"])
    reference = catalog.load_module("reference", cell["cfg"]["family"])
    seeds = [int(s) for s in a.seeds.split(",")]
    ctl = {int(s) for s in a.control_seeds.split(",") if s}
    precisions = tuple(a.precisions.split(","))
    runs = [(s, None) for s in seeds]
    fault_seeds = ([int(s) for s in a.fault_seeds.split(",")]
                   if a.fault_seeds else seeds)
    runs += [(s, f) for f in a.faults.split(",") if f for s in fault_seeds]
    rows = []
    for seed, fault in runs:
        row = reading(cell, seed, a.seconds, dev, family, reference,
                      fault is None and seed in ctl, fault, precisions)
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
    print(json.dumps({"workload": a.workload,
                      "summary": summary(rows, precisions)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
