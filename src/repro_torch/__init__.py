"""PyTorch/CUDA port of the PVQ serving stack.

Float matmuls outside the hand-written kernels (prefill attention, the
exact tail leg of packed decode, the float unembed) must run in full f32,
so TF32 is switched off for the process when the package is imported.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
