"""Share of the profiled segment's host window in which no kernel, copy or
memset ran on the device."""


def read(ctx):
    trace = ctx.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
