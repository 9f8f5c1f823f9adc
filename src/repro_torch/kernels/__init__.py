"""Hand-written Hopper kernels and their plain PyTorch versions.

``LAUNCHES`` counts the CUDA launches of each kernel wrapper; a wrapper adds
one where it launches its kernel and nowhere else, so a run can show that
its main path went through the kernels.
"""

from typing import Dict

LAUNCHES: Dict[str, int] = {
    "pvq_encode_batch": 0,
    "pvq_matmul": 0,
    "pvq_matmul_q": 0,
    "pvq_attn_q": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launches() -> Dict[str, int]:
    return dict(LAUNCHES)
