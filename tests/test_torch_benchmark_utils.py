"""The port's timing helpers (flatquant_torch/utils/benchmark.py) and
quantize_acts_sym (flatquant_torch/kernels/int4_matmul.py) against the
JAX package's (flatquant_tpu/utils/benchmark.py,
flatquant_tpu/kernels/int4_matmul.py:87), on the CPU.

quantize_acts_sym: codes and scales bit for bit (IEEE division on both
sides; the LAC factors are values at which torch.sigmoid equals
jax.nn.sigmoid, tests/test_torch_fake_quant.py). The wall-clock timers
run on CPU tensors; the device timers read a CUDA trace and raise on a
host without a card.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from flatquant_tpu.kernels.int4_matmul import quantize_acts_sym as j_qas
from flatquant_torch.kernels.int4_matmul import quantize_acts_sym
from flatquant_torch.utils import benchmark as tb


@pytest.mark.parametrize("clip", [None, 4.0, 1.0, -1.0])
def test_quantize_acts_sym_matches_jax(clip):
    """Codes (bf16, exact small integers) and float32 [T, 1] scales bit
    for bit, an all-zero row (scale 1) included, q_max 7 and 127."""
    rng = np.random.default_rng(21)
    x = (rng.standard_normal((9, 256)) * 3).astype(np.float32)
    x[4] = 0.0
    x[2, 7] = 40.0  # an outlier channel
    cm = None if clip is None else np.float32(clip)
    for q_max in (7, 127):
        wq, ws = j_qas(jnp.asarray(x), q_max=q_max, clip_max=cm)
        gq, gs = quantize_acts_sym(torch.from_numpy(x), q_max=q_max,
                                   clip_max=None if cm is None else
                                   torch.tensor(cm))
        assert gq.dtype == torch.bfloat16 and gs.dtype == torch.float32
        assert tuple(gs.shape) == (9, 1)
        np.testing.assert_array_equal(gq.float().numpy(),
                                      np.asarray(wq, np.float32))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
        assert float(gs[4, 0]) == 1.0 and not gq[4].any()


def test_chained_timer_and_compare_on_cpu():
    """The accumulator is the sum of every repetition's output (times
    1 + 1e-12 i); compare returns every case's positive seconds per
    iteration, and measure one positive number."""
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    calls = []

    def step(a):
        calls.append(1)
        return a * 2.0

    run = tb.chained_timer(step, (x,), iters=5)
    acc = run(x)
    assert len(calls) == 5
    want = sum(30.0 * (1.0 + 1e-12 * i) for i in range(5))
    assert acc.dtype == torch.float32 and abs(float(acc) - want) < 1e-4
    res = tb.compare({"double": (step, (x,)), "square": (lambda a: a * a,
                                                         (x,))},
                     iters=3, reps=2)
    assert set(res) == {"double", "square"}
    assert all(v > 0 for v in res.values())
    assert tb.measure(tb.chained_timer(step, (x,), 3), (x,), 3, reps=2) > 0


def _trace(names):
    """Device kernels of the given names, one a microsecond, and a host op
    beside them."""
    ev = [dict(ph="X", cat="kernel", name=n, ts=float(i), dur=0.5)
          for i, n in enumerate(names)]
    return ev + [dict(ph="X", cat="cpu_op", name="aten::mm", ts=0.0,
                      dur=9.0)]


def test_case_ops_find_the_work_between_the_sentinels():
    """_case_ops takes the device events between the leading and the
    trailing run of sentinel kernels in device time order (copies and
    fills count, host ops do not), whatever was dropped from the runs'
    outer ends; a run dropped whole, or a sentinel among the work's
    events, gives None (the trace is taken again)."""
    s = "void at::cuda::spin_kernel(long)"
    work = ["gemm", "norm", "gemm"]

    def names(events):
        return None if events is None else [e["name"] for e in events]

    assert names(tb._case_ops(_trace([s] * 4 + work + [s] * 4))) == work
    # the first sentinels dropped; the events out of time order
    assert names(tb._case_ops(_trace([s] + work + [s] * 2))) == work
    assert names(tb._case_ops(list(reversed(
        _trace([s] * 2 + work + [s]))))) == work
    # a whole run dropped (and maybe some of the work's events with it)
    assert tb._case_ops(_trace(work[1:] + [s] * 4)) is None
    assert tb._case_ops(_trace([s] * 4 + work[:2])) is None
    assert tb._case_ops(_trace([s] * 2 + ["gemm", s, "gemm"] + [s])) is None
    assert tb._case_ops(_trace([s] * 8)) == []
    assert tb._case_ops([]) is None
    # copies and fills are device work
    ev = _trace([s] * 2 + ["gemm"] + [s] * 2)
    ev += [dict(ph="X", cat="gpu_memset", name="Memset", ts=2.2, dur=0.1),
           dict(ph="X", cat="gpu_memcpy", name="Memcpy", ts=2.5, dur=0.1)]
    assert names(tb._case_ops(ev)) == ["gemm", "Memset", "Memcpy"]


def test_whole_calls_see_a_dropped_event():
    """device_compare retakes a trace unless every kernel, copy and fill
    name of its iters calls came a multiple of iters times."""
    def ev(*names):
        return [dict(name=n) for n in names]

    assert tb._whole_calls(ev("gemm", "norm") * 3, 3)
    assert tb._whole_calls([], 3)
    assert not tb._whole_calls(ev("gemm", "norm") * 3 + ev("gemm"), 3)
    assert not tb._whole_calls(ev("gemm", "norm") * 2 + ev("gemm"), 3)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_device_timers_raise_without_a_card():
    x = torch.ones(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.device_compare({"id": (lambda a: a + 1, (x,))}, iters=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.device_time_loop(lambda: None)
