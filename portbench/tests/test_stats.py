import types

import pytest

from portbench.harness import catalog, stats


def test_percentile_interpolates():
    assert stats.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([], 95) is None


def test_rate_over_the_window():
    assert stats.rate(50, 10.0, 12.5) == 20.0
    assert stats.rate(5, 1.0, 1.0) is None


class _R:
    def __init__(self, prompt_len, submit, stamps):
        self.prompt_len, self.submit_t = prompt_len, submit
        self.stamps = stamps
        self.req = types.SimpleNamespace(out_tokens=[0] * len(stamps))


def _ctx():
    """A window (10, 20]: a request admitted before it (its first token
    at 9), one whose first token comes in it, one finishing in it."""
    win = {"t0": 10.0, "t1": 20.0, "setup_s": 7.5, "peak_bytes": 3 * 2**30}
    a = _R(100, 8.0, [9.0, 11.0, 13.0])  # 2 tokens in the window
    b = _R(200, 12.0, [12.5, 12.5, 15.0, 21.0])  # 3 in, first in
    c = _R(50, 18.0, [19.0])  # first in
    win["done"], win["live"] = [a], [b, c]
    return types.SimpleNamespace(win=win)


@pytest.mark.parametrize("name,want", [
    ("tokens_per_s", (200 + 50 + 2 + 3 + 1) / 10.0),
    ("ttft_p95_ms.closed_loop", None),
    ("itl_p95_ms", None),
    ("peak_mem_gib", 3.0),
    ("setup_s", 7.5),
])
def test_end_to_end_readers(name, want):
    ctx = _ctx()
    got = catalog.load_module("metrics", name).read(ctx)
    if name == "ttft_p95_ms.closed_loop":
        want = stats.percentile([500.0, 1000.0], 95)
    if name == "itl_p95_ms":
        # gaps ending in the window: a 2, 2; b 0, 2.5 (21 is outside)
        want = stats.percentile([2000.0, 2000.0, 0.0, 2500.0], 95)
    assert got == pytest.approx(want)
