"""A run with the timed path broken underneath comes out not correct.

The harness's look for a chip is skipped (--device cpu, a tiny cell);
the rest of the run is driven as on the chip, with a fault of
harness/faults.py planted under the batcher: a token altered where it is
produced (every third decode call's logits rolled by one token), half of
the batch left out (the second half of the slots takes the first half's
logits). A sound run of the same seed comes out correct. The faults
inside the layers (harness/faults.py) are read at each cell's own size
on the card by calibrate.py --faults; here it is checked that each is
planted where the program runs."""

import json

import pytest
import torch

from portbench import calibrate, run
from portbench.harness import catalog, check, faults

DEV = torch.device("cpu")


@pytest.mark.parametrize("cell", ["tiny-qwen.prefill-heavy",
                                  "tiny-deepseek.chat"])
@pytest.mark.parametrize("fault,correct", [(None, True),
                                           ("token_altered", False),
                                           ("half_batch", False)])
def test_fault_makes_the_run_incorrect(cell, fault, correct, monkeypatch,
                                       capsys):
    torch.set_num_threads(2)
    fam = catalog.load_module(
        "families", catalog.cell(cell)["cfg"]["family"])
    orig = fam.batcher

    def batcher(*a, **k):
        b = orig(*a, **k)
        if fault is not None:
            faults.plant(fault, b)
        return b

    monkeypatch.setattr(fam, "batcher", batcher)
    rc = run.main(["--workload", cell, "--seed", "5", "--seconds", "1",
                   "--trace", "0", "--device", "cpu"])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is correct, res["compared"]


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c, fam in (("tiny-qwen.prefill-heavy", "llama"),
                          ("tiny-deepseek.chat", "deepseek"))
    for f in faults.FAMILY[fam]])
def test_each_fault_reaches_the_served_logits(cell, fault):
    """Planted at a tiny size, every fault changes what the program
    serves (its tokens or their logits), and undoing it restores the
    sound run."""
    torch.set_num_threads(2)
    c = catalog.cell(cell)
    c["cfg"]["weights"]["out_scale"] = 0.5
    if c["batcher"]["cache_mode"] == "paged":
        # prompts past the first block, so a block before the newest exists
        bs = c["batcher"]["block_size"]
        c["traffic"]["prompt"].update(median=bs + 20, min=bs + 2,
                                      max=bs + 40)
    fam = catalog.load_module("families", c["cfg"]["family"])

    def served(f):
        with torch.no_grad():
            win, _, _, _ = run.serve_cell(c, 7, 0.5, DEV, False, fam, f)
        return {r.rid: (tuple(r.req.out_tokens),
                        tuple(win["tapped"][id(r.req)].values()))
                for r in win["done"]}

    sound, broken, again = served(None), served(fault), served(None)
    assert all(sound[k] == again[k] for k in sound.keys() & again.keys())
    common = sound.keys() & broken.keys()
    assert common and any(sound[k] != broken[k] for k in common)


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in
                                  catalog.manifest()["workloads"]])
def test_output_faults_at_the_cells_size(name, cuda):
    """At the cell's own size on the card, each fault at the output reads
    past a limit of the cell on three seeds. (The faults inside the
    layers read under it there: calibrate.py --faults gives their
    readings.)"""
    cell = catalog.cell(name)
    fam = catalog.load_module("families", cell["cfg"]["family"])
    ref = catalog.load_module("reference", cell["cfg"]["family"])
    prec = check.PRECISION
    for fault in ("token_altered", "half_batch"):
        for seed in (111, 112, 113):
            r = calibrate.reading(cell, seed, 8, cuda, fam, ref, False,
                                  fault, (prec,))
            nums = r["program"][prec]
            assert any(nums[k] > lim
                       for k, lim in cell["check"]["limits"].items()), \
                (fault, seed, nums)
