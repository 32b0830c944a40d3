"""Share of the traced slice's device time launched under the routed
experts' span (models/deepseek.py `_routed_experts`)."""

UNIT, LAYER, MOVES, SOURCE = ("%", "DeepSeek MoE (models/deepseek.py)",
                              "tokens_per_s", "device_trace")


def read(ctx):
    if ctx.slice is None:
        return None
    total = sum(o["dur"] for o in ctx.slice["ops"])
    moe = sum(o["dur"] for o in ctx.slice["ops"]
              if "routed_experts" in o["spans"])
    return 100.0 * moe / total if moe and total else None
