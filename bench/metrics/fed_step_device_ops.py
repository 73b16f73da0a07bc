"""Device kernels, copies and memsets of the profiled round over its
batched steps."""


def read(ctx):
    trace, steps = ctx.get("trace"), ctx.get("units")
    if not trace or not steps:
        return None
    return len(trace["device"]) / steps
