"""``generate``'s decode time per step over the window's calls:
``sum(decode_s) / sum(steps)`` (each call's decode is timed between two
synchronisations).  The call the profiler recorded is left out."""

from bench.core.untraced import batch_calls

LAYER = "serve (launch/serve.py)"
MOVES = "output_tok_s"
UNIT = "ms"


def read(run):
    calls = batch_calls(run)
    if not calls:
        return None
    return 1e3 * sum(c["decode_s"] for c in calls) / (len(calls) * run.obs["gen"])
