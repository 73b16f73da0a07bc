"""Mean over the window's rounds of the ``round`` event's duration less its
``train`` span (``obs/trace.py`` spans of ``Federation.run``), in ms."""


def read(ctx):
    s = ctx.get("round_overhead_s")
    return None if s is None else s * 1e3
