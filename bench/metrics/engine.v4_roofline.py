"""Kernel v4 (``pvq_attn_q``) over the PVQ KV pages in the traced span of
the engine (decode steps and the chunk caller): bound time over device
time, in percent."""

from bench.core.model_step import roofline

LAYER = "kernels (kernels/csrc)"
MOVES = "tpot_p90_ms"
UNIT = "%"


def read(run):
    return roofline(run, "v4", ("pvq_attn",))
