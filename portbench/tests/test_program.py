"""harness/program.py on a synthetic slice: the program's spans mapped
onto the device timeline by the clocks' offset, device time by the
innermost span at each launch, idle gaps split among the innermost spans
that overlap them, and the metrics the records give."""

import json

import pytest

from portbench.harness import program

OFFSET = 1000.0  # trace seconds - host seconds


def _k(name, ts_us, dur_us, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts_us,
            "dur": dur_us, "args": {"correlation": corr}}


def _launch(ts_us, corr, dur_us=2.0):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts_us, "dur": dur_us, "args": {"correlation": corr}}


def _us(host_s):
    return (host_s + OFFSET) * 1e6


def _trace(tmp_path, ops):
    """Sentinels around `ops` [(launch host s, start host s, dur s)]; the
    last leading sentinel's launch ends at host 10.0, the first trailing
    one runs at host 12.0."""
    ev = []
    for i in range(3):
        ev += [_launch(_us(9.99) + i * 2, i),
               _k("spin_kernel", _us(9.995) + i, 1, i)]
    ev[-2]["ts"] = _us(10.0) - 2.0
    ev[-1]["ts"], ev[-1]["dur"] = _us(10.0) - 1.0, 1.0
    for i, (ln, start, dur) in enumerate(ops):
        corr = 10 + i
        if ln is not None:
            ev.append(_launch(_us(ln), corr))
        ev.append(_k(f"op{i}", _us(start), dur * 1e6, corr))
    for i in range(3):
        ev += [_launch(_us(11.99) + i, 90 + i),
               _k("spin_kernel", _us(12.0) + i * 2, 1, 90 + i)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


# host spans: a step [10.1, 11.9] holding a decode [10.2, 11.0] with a
# layer [10.3, 10.8] whose mlp is [10.5, 10.8] and a sync [10.9, 11.0],
# and a prefill [11.2, 11.8]; a queued wait over all of it
SPANS = [
    (5, 4, "mlp", 10.5, 10.8, {}),
    (4, 2, "layer", 10.3, 10.8, {"i": 0}),
    (6, 2, "sync", 10.9, 11.0, {"site": "d2h.sample"}),
    (2, 1, "decode", 10.2, 11.0, {}),
    (7, 1, "prefill", 11.2, 11.8, {}),
    (1, None, "step", 10.1, 11.9, {}),
    (8, None, "queued", 9.0, 11.5, {"rid": 3}),
]


def test_read_ties_the_clocks(tmp_path):
    sl = program.read(_trace(tmp_path, [(10.55, 10.6, 0.1),
                                        (None, 11.3, 0.2)]), {"lead": 10.0})
    assert sl["offset_s"] == pytest.approx(OFFSET)
    assert sl["t0"] == pytest.approx(OFFSET + 10.0)
    assert sl["t1"] == pytest.approx(OFFSET + 12.0)
    assert [o["launch_s"] for o in sl["ops"]] == [pytest.approx(10.55),
                                                  None]
    assert program.read(_trace(tmp_path, []), {}) is None


def test_paths_and_timeline():
    names = program.paths(SPANS)
    assert names[5] == "decode/layer/mlp"
    assert names[6] == "decode/sync.d2h.sample"
    assert names[1] == "" and names[8] == "queued"
    tl = program.Timeline(SPANS)
    assert tl.at(10.6) == "decode/layer/mlp"
    assert tl.at(10.4) == "decode/layer"
    assert tl.at(10.85) == "decode"
    assert tl.at(11.1) == ""  # the step's own time
    assert tl.at(9.5) == program.OUTSIDE  # queued takes no part
    parts = tl.split(10.7, 11.3)
    assert parts == {"decode/layer/mlp": pytest.approx(0.1),
                     "decode": pytest.approx(0.1),
                     "decode/sync.d2h.sample": pytest.approx(0.1),
                     "": pytest.approx(0.2), "prefill": pytest.approx(0.1)}
    assert tl.split(11.8, 12.0) == {"": pytest.approx(0.1),
                                    program.OUTSIDE: pytest.approx(0.1)}


def test_join_attributes_ops_and_gaps(tmp_path):
    # busy [10.6, 10.7] (launched in the mlp) and [11.3, 11.5] (placed by
    # its own start, in the prefill); idle [10.0, 10.6], [10.7, 11.3],
    # [11.5, 12.0]
    sl = program.read(_trace(tmp_path, [(10.55, 10.6, 0.1),
                                        (None, 11.3, 0.2)]), {"lead": 10.0})
    j = program.join(sl, SPANS)
    assert j["device_time"] == {"decode/layer/mlp": pytest.approx(0.1),
                                "prefill": pytest.approx(0.2)}
    assert j["busy_s"] == pytest.approx(0.3)
    assert j["idle_s"] == pytest.approx(1.7)
    idle = j["idle"]
    assert idle[program.OUTSIDE] == pytest.approx(0.1 + 0.1)
    assert idle[""] == pytest.approx(0.1 + 0.2 + 0.1)
    assert idle["decode"] == pytest.approx(0.1 + 0.1)
    assert idle["decode/layer"] == pytest.approx(0.2)
    assert idle["decode/layer/mlp"] == pytest.approx(0.1 + 0.1)
    assert idle["decode/sync.d2h.sample"] == pytest.approx(0.1)
    assert idle["prefill"] == pytest.approx(0.1 + 0.3)
    assert program.under(idle, "decode") == pytest.approx(0.7)
    assert program.under(idle, "decode", strictly=True) == pytest.approx(0.5)
    assert j["calls"] == {"step": 1, "decode": 1, "layer": 1, "mlp": 1,
                          "sync": 1, "prefill": 1}
    assert {p for p, _ in program.top(idle, 2)} == {"", "prefill"}


def test_metrics_read_spans_and_counters(tmp_path):
    counters = {"prefill.rows_true": 90, "prefill.rows_computed": 120,
                "moe.rows_useful": 6, "moe.rows_computed": 64,
                "host_syncs": 13}
    sl = program.read(_trace(tmp_path, [(10.55, 10.6, 0.1)]),
                      {"lead": 10.0})
    m = program.metrics(SPANS, counters, program.join(sl, SPANS))
    assert m == {"queue_wait_ms": pytest.approx(2500.0),
                 "prefill_useful_share": pytest.approx(75.0),
                 "moe_useful_share": pytest.approx(100 * 6 / 64),
                 "host_syncs_per_step": pytest.approx(13.0),
                 "decode_idle_ms": pytest.approx(1e3 * 0.7)}
    # nothing to read: the key is left out
    assert program.metrics([], {}) == {}
