"""The plain reference: the served models written out in plain PyTorch in
float32 (TF32 off), with the serving path's quantization worked out again
from the float weights (PVQ weights, int8 activations, PVQ KV pages).  It
imports nothing of the program and takes none of its weights, scales or
tables."""
