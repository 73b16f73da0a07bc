"""6 N D model FLOPs of the window's real samples a second (N the model's
13,281 params, D its 24 time steps a sample) over the card's 67 TFLOP/s of
float32 outside the tensor cores (the configuration keeps TF32 off)."""

from harness import work


def read(ctx):
    rate = ctx.get("rate")
    if not rate or "time_steps" not in ctx:
        return None
    return 100.0 * work.model_flops(ctx["params"], ctx["time_steps"]) * rate / work.PEAK_F32_FLOPS
