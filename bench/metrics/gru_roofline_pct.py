"""The least time of the profiled round's GRU work as the setting requires it
(real samples only, forward and backward once a layer; ``harness/work.py``)
over the device time of the GRU kernel family in the profile
(``gru_roofline_pct.json``)."""

import json
from pathlib import Path

from harness import profile, work

FAMILY = json.loads((Path(__file__).with_suffix(".json")).read_text())["kernels"]


def read(ctx):
    trace, w = ctx.get("trace"), ctx.get("work")
    if not trace or not w:
        return None
    device_s = profile.family_seconds(trace, FAMILY)
    if device_s <= 0:
        return None
    calls = w["samples"] if w["per_example"] else w["client_steps"]
    bound = work.gru_round_bound_s(w["samples"], calls, w["time_steps"], w["hidden"], w["layers"])
    return 100.0 * bound / device_s
