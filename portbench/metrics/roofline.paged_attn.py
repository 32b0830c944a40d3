"""The paged int4 attention's share of its roofline (rows 10, 11 of the
kernel table: kernels/paged_kv.py): decode attention over each active
slot's valid length (query bf16, K and V codes with their scale and
zero), against the kernels named in metrics/roofline.paged_attn/."""

from portbench.harness.work import roofline_share

UNIT, LAYER, MOVES, SOURCE = "%", "kernels (kernels/)", "tokens_per_s", \
    "device_trace"


def read(ctx):
    return roofline_share(ctx, "roofline.paged_attn", "paged_attn")
