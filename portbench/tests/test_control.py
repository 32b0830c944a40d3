"""The control: the reference put in the program's place and computed in
the precision below the configuration's bf16 (float8 e4m3 wherever the
program holds bf16) comes out not correct, while the program does not.

On the CPU at a size a test run holds (small-qwen: hidden 256, 4 layers,
the plain versions), over a fixed number of scheduler steps; on the card
(-m gpu) at each cell's own size, through calibrate.py's readings."""

import numpy as np
import pytest
import torch

from portbench import calibrate
from portbench.harness import catalog, check, serve
from portbench.reference.common import PRECISIONS, fp8_e4m3

DEV = torch.device("cpu")


def _readings(name, seed, steps=40):
    """(limits, the program's numbers, the control's numbers) against the
    reference at check.PRECISION."""
    cell = catalog.cell(name)
    cfg = cell["cfg"]
    fam = catalog.load_module("families", cfg["family"])
    ref = catalog.load_module("reference", cfg["family"])
    b = fam.batcher(fam.build(cfg, seed, DEV), cell["batcher"], DEV)
    tap = serve.Tap(b)
    t = catalog.load_module("traffic", "closed_loop").Traffic(
        cell["traffic"], seed, cfg["vocab_size"])
    live, done = serve.fill(b, t), []
    for i in range(steps):
        b.step()
        live = serve._advance(b, t, live, float(i), done)
    picks = check.sample(done, seed, cell["check"]["served_tokens"])
    seqs = check.sequences(picks)
    r = ref.logits(cfg, seed, seqs, DEV,
                   rnd=PRECISIONS[check.PRECISION])
    low = ref.logits(cfg, seed, seqs, DEV, rnd=fp8_e4m3)
    prog = check.numbers(r, [p.req.out_tokens for p in picks],
                         check.served_logits(picks, tap.values()))
    ctl = check.numbers(r, [lg.argmax(-1).numpy() for lg in low],
                        [lg.amax(-1).numpy() for lg in low])
    return cell["check"]["limits"], prog, ctl


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_where_the_program_passes(seed):
    torch.set_num_threads(2)
    limits, prog, ctl = _readings("small-qwen.prefill-heavy", seed)
    assert all(prog[k] <= lim for k, lim in limits.items()), (prog, limits)
    assert any(ctl[k] > lim for k, lim in limits.items()), (ctl, limits)


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in
                                  catalog.manifest()["workloads"]])
def test_control_at_the_cells_size(name, cuda):
    cell = catalog.cell(name)
    fam = catalog.load_module("families", cell["cfg"]["family"])
    ref = catalog.load_module("reference", cell["cfg"]["family"])
    prec = check.PRECISION
    rows = [calibrate.reading(cell, seed, 12, cuda, fam, ref, True, None,
                              (prec,))
            for seed in (101, 102, 103)]
    limits = cell["check"]["limits"]
    for r in rows:
        assert all(r["program"][prec][k] <= lim for k, lim in limits.items())
        assert any(r["control"][prec][k] > lim for k, lim in limits.items())
    assert all(np.isfinite(lim) for lim in limits.values())
