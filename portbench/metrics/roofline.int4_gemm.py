"""The W4A4 GEMMs' share of their roofline (rows 1, 6, 13 of the kernel
table: kernels/int4_matmul.py, kernels/flat_pipeline.py): every W4A4
linear outside the routed experts at the calls' true rows, against the
kernels named in metrics/roofline.int4_gemm/."""

from portbench.harness.work import roofline_share

UNIT, LAYER, MOVES, SOURCE = "%", "kernels (kernels/)", "tokens_per_s", \
    "device_trace"


def read(ctx):
    return roofline_share(ctx, "roofline.int4_gemm", "int4_gemm")
