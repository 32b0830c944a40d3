"""trace.read on a synthetic slice: sentinels, ops launched inside the
host spans of two forward calls, the clocks tied by the sentinels'
launches."""

import json

import pytest

from portbench.harness import trace

OFFSET = 1000.0  # trace seconds - host seconds


def _k(name, ts_us, dur_us, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts_us,
            "dur": dur_us, "args": {"correlation": corr}}


def _launch(ts_us, corr, dur_us=2.0):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts_us, "dur": dur_us, "args": {"correlation": corr}}


def _host(t):
    return (t + OFFSET) * 1e6


def test_slice_attribution(tmp_path):
    ev = []
    # leading sentinels, the last launch ending at host 10.0
    for i in range(3):
        ev += [_launch(_host(9.99) + i * 2, i),
               _k("spin_kernel", _host(9.999) + i, 1, i)]
    ev[-2]["ts"] = _host(10.0) - 2.0
    # forward 0 (prefill) on host [10.1, 10.4], 1 (decode) [10.5, 10.9]
    ev += [_launch(_host(10.2), 10),
           _k("w4a4_matmul_i8_tile_kernel", _host(10.25), 100e3, 10),
           _launch(_host(10.6), 11), _k("elementwise", _host(10.6), 50e3, 11),
           _k("orphan_copy", _host(10.8), 10e3, 99)]
    # trailing sentinels, the first launched at host 11.0
    for i in range(3):
        ev += [_launch(_host(11.0) + i * 2, 20 + i),
               _k("spin_kernel", _host(11.01) + i * 2, 1, 20 + i)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    fwds = [{"n": 0, "phase": "prefill", "slice": True, "t0": 10.1,
             "t1": 10.4},
            {"n": 1, "phase": "decode", "slice": True, "t0": 10.5,
             "t1": 10.9}]
    sl = trace.read(str(path), {"lead": 10.0, "trail": 11.0}, fwds,
                    [("routed_experts", 10.55, 10.65)])
    names = {o["name"]: o for o in sl["ops"]}
    assert names["w4a4_matmul_i8_tile_kernel"]["fwd"] == 0
    assert names["elementwise"]["fwd"] == 1
    assert names["elementwise"]["spans"] == {"routed_experts"}
    assert names["orphan_copy"]["fwd"] == 1  # placed by its own start
    assert sl["attributed"] == pytest.approx(2 / 3)
    assert sl["busy_s"] == pytest.approx(0.16)
    assert sl["window_s"] == pytest.approx(11.01 - (9.999 + 3e-6),
                                           abs=1e-5)
    assert sl["drift_s"] == pytest.approx(0.0, abs=1e-5)
    labels = {k for k, _ in trace.breakdown(sl)["idle_gaps"]}
    assert labels == {"host between model calls", "host in a prefill call",
                      "host in a decode call"}
