"""The lockstep calls' share of the chip's int8 peak: the model's
operations for every prompt position and every returned token of the
window's calls, over the calls' time, in percent (the call the profiler
recorded left out)."""

from bench.core.model_step import batch_mfu

LAYER = "whole step"
MOVES = "output_tok_s"
UNIT = "%"


def read(run):
    return batch_mfu(run)
