"""Share of ``generate``'s time that its prefill takes over the window's
calls: ``sum(prefill_s) / sum(prefill_s + decode_s)``, in percent.  The
call the profiler recorded is left out."""

from bench.core.untraced import batch_calls

LAYER = "serve (launch/serve.py)"
MOVES = "output_tok_s"
UNIT = "%"


def read(run):
    calls = batch_calls(run)
    if not calls:
        return None
    pre = sum(c["prefill_s"] for c in calls)
    return 100.0 * pre / (pre + sum(c["decode_s"] for c in calls))
