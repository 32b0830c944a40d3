import types

import pytest

from portbench.harness import catalog, work


def test_gemm_counts():
    kind, ops, nbytes, peak = work.gemm(2, 4, 8)
    assert (kind, ops, peak) == ("int4_gemm", 2 * 2 * 4 * 8, work.PEAK_INT8)
    # int8 x [2, 4], int4 w [8, 4], f32 scales 2 + 8, bf16 y [2, 8]
    assert nbytes == 8 + 16 + 8 + 32 + 32
    assert work.gemm(2, 4, 8, out_cols=4)[2] == 8 + 16 + 8 + 32 + 16


def test_least_time_is_the_larger_bound():
    assert work.least_seconds(1979e12, 0, work.PEAK_INT8) == 1.0
    assert work.least_seconds(0, 3.35e12, work.PEAK_INT8) == 1.0
    assert work.least_seconds(1979e9, 3.35e12, work.PEAK_INT8) == 1.0


@pytest.mark.parametrize("fwd,keys", [
    ({"phase": "prefill", "rows": 4, "start": 0}, 1 + 2 + 3 + 4),
    ({"phase": "chunk", "rows": 2, "start": 3}, 4 + 5),
    ({"phase": "decode", "valid": [3, 5]}, 8),
])
def test_attended_keys(fwd, keys):
    assert work.attended_keys(fwd) == keys


def test_qwen_decode_work():
    """A 32-slot decode call: each layer's four W4A4 GEMMs at 32 rows,
    the paged attention over the slots' valid lengths, the head on 32
    rows."""
    cell = catalog.cell("qwen2.5-7b.prefill-heavy")
    fam = catalog.load_module("families", "llama")
    fwd = {"phase": "decode", "rows": 32, "start": 0, "valid": [100] * 32,
           "emitted": 32}
    items = fam.work(cell["cfg"], fwd)
    g = [i for i in items if i[0] == "int4_gemm"]
    assert len(g) == 4 * 28
    H, I = 3584, 18944
    assert g[0][1] == 2 * 32 * H * 4608 and g[2][1] == 2 * 32 * H * 2 * I
    att = [i for i in items if i[0] == "paged_attn"]
    assert len(att) == 28
    assert att[0][1] == 2 * 28 * 256 * 3200
    assert att[0][2] == 3200 * 4 * (128 + 16) + 32 * 28 * 128 * 4
    head = [i for i in items if i[0] == "head"]
    assert head[0][1] == 2 * 32 * H * 152064


def test_deepseek_counts_active_experts_only():
    cell = catalog.cell("deepseek-v2-lite.chat")
    fam = catalog.load_module("families", "deepseek")
    fwd = {"phase": "chunk", "rows": 512, "start": 0, "emitted": 0}
    items = fam.work(cell["cfg"], fwd)
    routed = [i for i in items if i[0] == "routed"]
    assert len(routed) == 26
    assert routed[0][1] == 2 * 512 * 6 * 3 * 2048 * 1408
    assert [i for i in items if i[0] == "head"][0][1] == 0


def _ctx(op_s, slice_s):
    cell = catalog.cell("qwen2.5-7b.prefill-heavy")
    fam = catalog.load_module("families", "llama")
    fwd = {"n": 0, "phase": "decode", "rows": 32, "start": 0,
           "valid": [100] * 32, "emitted": 32, "slice": True}
    ops = [{"name": "void w4a4_matmul_i8_tile_kernel<bf16>(...)",
            "dur": op_s, "fwd": 0, "spans": set()},
           {"name": "elementwise_kernel", "dur": 1.0, "fwd": 0,
            "spans": set()}]
    sl = {"ops": ops, "window_s": slice_s, "busy_s": op_s + 1.0,
          "gaps": []}
    return types.SimpleNamespace(cfg=cell["cfg"], family=fam, forwards=[fwd],
                                 slice=sl, kernel_names=catalog.kernel_names)


def test_roofline_share_reads_its_kernels_only():
    ctx = _ctx(1.0, 10.0)
    least = work.least_time(ctx.family.work(ctx.cfg, ctx.forwards[0]),
                            "int4_gemm")
    ctx = _ctx(least, 10.0)
    share = catalog.load_module("metrics", "roofline.int4_gemm").read(ctx)
    assert share == pytest.approx(100.0)
    ctx.slice["ops"][0]["name"] = "some_other_kernel"
    assert catalog.load_module("metrics",
                               "roofline.int4_gemm").read(ctx) is None


def test_mfu_and_idle_share():
    ctx = _ctx(1.0, 10.0)
    ops = work.model_ops(ctx.family.work(ctx.cfg, ctx.forwards[0]))
    mfu = catalog.load_module("metrics", "mfu").read(ctx)
    assert mfu == pytest.approx(100.0 * ops / (10.0 * work.PEAK_INT8))
    idle = catalog.load_module("metrics", "idle_share").read(ctx)
    assert idle == pytest.approx(80.0)
