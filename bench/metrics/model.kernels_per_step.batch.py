"""Device kernels a lockstep decode step runs, averaged over the traced
steps of one ``generate`` call."""

from bench.core.model_step import kernels_per_step

LAYER = "model step (nn, launch/capture.py)"
MOVES = "output_tok_s"
UNIT = "kernels"


def read(run):
    return kernels_per_step(run, "decode")
