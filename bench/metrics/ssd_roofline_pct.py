"""The least time of the SSD work a train step requires (one forward and one
backward of the chunk scan a layer, float32 as the model computes the
scan; ``harness/work.py``: bytes over 3.35 TB/s against the operations at
the tensor cores' 3xTF32 and the CUDA cores' rates) over the device time
of every SSD launch of the profiled steps (``ssd_roofline_pct.json``):
remat's second forward counts in the time, not in the work."""

import json
from pathlib import Path

from harness import profile, work

FAMILY = json.loads((Path(__file__).with_suffix(".json")).read_text())["kernels"]


def read(ctx):
    trace, ssd = ctx.get("trace"), ctx.get("ssd_shape")
    if not trace or not ssd or not ctx.get("units"):
        return None
    device_s = profile.family_seconds(trace, FAMILY)
    if device_s <= 0:
        return None
    shape = ssd["shape"]
    fb, fops, _, fmma, fmma16 = work.ssd_work(*shape)
    bb, bops, bmma, bmma16 = work.ssd_bwd_work(*shape)
    fwd = max(fb / work.PEAK_BYTES_PER_S, work.tensor_core_ms(fops, fmma, fmma16) / 1e3)
    bwd = max(bb / work.PEAK_BYTES_PER_S, work.tensor_core_ms(bops, bmma, bmma16) / 1e3)
    bound = (fwd + bwd) * ssd["layers"] * ctx["units"]
    return 100.0 * bound / device_s
