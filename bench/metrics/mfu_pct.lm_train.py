"""6 N D model FLOPs of the window's tokens a second (N = 128,983,488 params;
recompute not counted) over the card's 989 TFLOP/s of dense bf16."""

from harness import work


def read(ctx):
    rate = ctx.get("rate")
    if not rate or "tokens_a_step" not in ctx:
        return None
    return 100.0 * work.model_flops(ctx["params"], 1) * rate / work.PEAK_16BIT_FLOPS
