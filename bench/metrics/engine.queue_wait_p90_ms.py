"""90th percentile, over the window's requests, of the wait from when it
was due to its admission (``Request.admit_t``).  In a traced run, over the
requests due before the profiler started (``core/untraced.py``)."""

from bench.core.stats import percentile
from bench.core.untraced import engine_records

LAYER = "engine (launch/engine.py)"
MOVES = "ttft_p90_ms"
UNIT = "ms"


def read(run):
    recs = engine_records(run)
    if not recs:
        return None
    return 1e3 * percentile([x["queue_s"] for x in recs], 90)
