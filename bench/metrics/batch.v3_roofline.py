"""Kernel v3 on the 2-D route in the traced span of a lockstep call (its
prefill and decode steps): bound time over device time, in percent."""

from bench.core.model_step import roofline

LAYER = "kernels (kernels/csrc)"
MOVES = "output_tok_s"
UNIT = "%"


def read(run):
    return roofline(run, "v3", ("pvq_matmul_q_", "OneMatrix"))
