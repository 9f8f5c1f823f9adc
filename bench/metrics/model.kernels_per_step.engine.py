"""Device kernels a decode step of the engine runs (its graph's kernels
and the step's glue), averaged over the traced steps."""

from bench.core.model_step import kernels_per_step

LAYER = "model step (nn, launch/capture.py)"
MOVES = "tpot_p90_ms"
UNIT = "kernels"


def read(run):
    return kernels_per_step(run, "decode")
