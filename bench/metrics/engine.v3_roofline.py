"""Kernel v3 on the 2-D route (``pvq_matmul_q``, ``OneMatrix``) in the
traced span of the engine: the least time its calls could take (decode
steps, chunks and batched prefills, from their shapes) over their device
time, in percent."""

from bench.core.model_step import roofline

LAYER = "kernels (kernels/csrc)"
MOVES = "tpot_p90_ms"
UNIT = "%"


def read(run):
    return roofline(run, "v3", ("pvq_matmul_q_", "OneMatrix"))
