"""Mean host wall of the engine's decode steps over the window (each span
ends in the step's read of its tokens, which waits for the device).  In a
traced run, over the steps begun before the profiler started."""

from bench.core.stats import mean
from bench.core.untraced import decode_steps

LAYER = "engine (launch/engine.py)"
MOVES = "tpot_p90_ms"
UNIT = "ms"


def read(run):
    steps = decode_steps(run)
    if not steps:
        return None
    return 1e3 * mean([s for s, _ in steps])
