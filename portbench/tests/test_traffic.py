import numpy as np
import pytest

from portbench.harness import catalog

CELLS = ["qwen2.5-7b.prefill-heavy", "deepseek-v2-lite.chat"]


def _stream(cell, seed, n):
    t = catalog.load_module("traffic", cell["traffic"]["kind"]).Traffic(
        cell["traffic"], seed, cell["cfg"]["vocab_size"])
    return t.first_wave(), [t.next() for _ in range(n)]


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_stream(name):
    cell = catalog.cell(name)
    a, b = _stream(cell, 2**31 + 11, 40), _stream(cell, 2**31 + 11, 40)
    for (pa, na), (pb, nb) in zip(a[0] + a[1], b[0] + b[1]):
        assert na == nb and np.array_equal(pa, pb)


@pytest.mark.parametrize("name", CELLS)
def test_every_seed_serves_the_same_sizes(name):
    """Each block of `strata` requests holds every stratum once, so seeds
    differ only in order and token ids."""
    cell = catalog.cell(name)
    k = cell["traffic"]["strata"]
    c = cell["traffic"]["clients"]
    wave = -(-c // k) * k - c  # the first wave's leftover of a block
    sizes = {}
    for seed in (1, 2, 3**20):
        _, reqs = _stream(cell, seed, wave + 3 * k)
        blocks = [reqs[wave + i * k:wave + (i + 1) * k] for i in range(3)]
        sizes[seed] = [(sorted(len(p) for p, _ in b), sorted(n for _, n in b))
                       for b in blocks]
    assert sizes[1] == sizes[2] == sizes[3**20]
    _, r1 = _stream(cell, 1, 8)
    _, r2 = _stream(cell, 2, 8)
    assert any(not np.array_equal(a, b) for (a, _), (b, _) in zip(r1, r2))


@pytest.mark.parametrize("name", CELLS)
def test_sizes_within_the_mix(name):
    cell = catalog.cell(name)
    tr = cell["traffic"]
    wave, reqs = _stream(cell, 5, 64)
    for p, n in reqs:
        assert tr["prompt"]["min"] <= len(p) <= tr["prompt"]["max"]
        assert tr["output"]["min"] <= n <= tr["output"]["max"]
        assert p.min() >= 0 and p.max() < cell["cfg"]["vocab_size"]
        assert len(p) + n <= cell["batcher"]["max_len"]
    assert len(wave) == tr["clients"]
    outs = sorted(n for _, n in wave)
    assert outs[0] >= 1 and outs[-1] <= tr["output"]["max"]
    assert len(set(outs)) > len(outs) // 2  # spread, not one length


@pytest.mark.parametrize("strata", [4, 16, 128])
def test_balanced_order_spreads_every_aligned_run(strata):
    """Every aligned run of 2^k slots of a block takes one slice from
    each of 2^k equal groups of the range, whatever the mask."""
    mod = catalog.load_module("traffic", "closed_loop")
    spec = {"dist": "uniform", "min": 1, "max": 1000}
    t = mod.Traffic({"clients": 1, "strata": strata, "prompt": spec,
                     "output": spec}, 9, 100)
    for _ in range(8):
        order = t._order()
        assert sorted(order) == list(range(strata))
        run = 1
        while run <= strata:
            groups = strata // run
            for at in range(0, strata, run):
                assert sorted(i // groups for i in order[at:at + run]) == \
                    list(range(run))
            run *= 2


def test_first_wave_is_the_residual_of_the_output_mix():
    """The first wave's output lengths have the mean of the residual
    E[X^2] / (2 E[X]), not that of the mix."""
    mod = catalog.load_module("traffic", "closed_loop")
    spec = {"dist": "lognormal", "median": 129, "sigma": 0.8, "min": 8,
            "max": 1024}
    t = mod.Traffic({"clients": 256, "strata": 16, "prompt": spec,
                     "output": spec}, 3, 100)
    xs = np.asarray(t.output_sizes, float)
    want = (xs ** 2).mean() / (2 * xs.mean()) + 0.5
    got = np.mean(t.residuals(256))
    assert abs(got - want) < 0.03 * want, (got, want)
    assert max(t.residuals(256)) <= xs.max()
