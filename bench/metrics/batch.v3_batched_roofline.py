"""Kernel v3 on the expert-batched route (``ExpertStack``: the MoE
banks) in the traced span of a lockstep call: bound time over device
time, in percent."""

from bench.core.model_step import roofline

LAYER = "kernels (kernels/csrc)"
MOVES = "output_tok_s"
UNIT = "%"


def read(run):
    return roofline(run, "v3_batched", ("pvq_matmul_q_", "ExpertStack"))
