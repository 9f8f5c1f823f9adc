"""The training steps' share of the chip's bf16 peak: the model's
operations (times 3 for the backward pass) for every position of every
row, over the steps' time, in percent (the steps the profiler recorded
left out)."""

from bench.core.model_step import train_mfu

LAYER = "whole step"
MOVES = "train_tok_s"
UNIT = "%"


def read(run):
    return train_mfu(run)
