"""Share of the traced span in which no operation ran on the device, in
percent."""

LAYER = "device"
MOVES = "tpot_p90_ms"
UNIT = "%"


def read(run):
    s = run.summary
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * max(1.0 - s.busy_s / s.window_s, 0.0)
