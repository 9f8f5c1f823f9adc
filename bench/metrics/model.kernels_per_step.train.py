"""Device kernels a training step runs (forward, backward, the QAT
projection and the optimizer), averaged over the traced steps."""

from bench.core.model_step import kernels_per_step

LAYER = "model step (nn, launch/capture.py)"
MOVES = "train_tok_s"
UNIT = "kernels"


def read(run):
    return kernels_per_step(run, "train")
