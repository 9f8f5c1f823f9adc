"""The engine's decode steps' share of the chip's int8 peak: the model's
operations for every active slot's token (its matrices, attention at its
context and the head) summed over the window's decode steps, over their
summed host spans, in percent (in a traced run, the steps begun before
the profiler started)."""

from bench.core.model_step import engine_mfu

LAYER = "whole step"
MOVES = "tpot_p90_ms"
UNIT = "%"


def read(run):
    return engine_mfu(run)
