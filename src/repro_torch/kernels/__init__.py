"""Hand-written Hopper kernels and their plain PyTorch versions.

``LAUNCHES`` counts the CUDA launches of each kernel wrapper; a wrapper adds
one where it launches its kernel and nowhere else, so a run can show that
its main path went through the kernels.  ``V3_BODY_LAUNCHES`` splits kernel
v3's launches (2-D and batched together) by the body that ran:
``"splitk"`` (m <= 8: the contraction split over CTAs), ``"mma"`` (int8
tensor cores, m > 8) or ``"direct"`` (the ragged rest); see
``pvq_matmul._v3_body``.  ``V2_BODY_LAUNCHES`` does
the same for kernel v2: ``"splitk"`` (m <= 8: the contraction split over
CTAs with f64 partials), ``"mma"`` (f64 tensor cores, m > 8) or
``"direct"`` (f64 FMAs on the CUDA cores: the ragged rest); see
``pvq_matmul._v2_body``.
"""

from typing import Dict

LAUNCHES: Dict[str, int] = {
    "pvq_encode_batch": 0,
    "pvq_matmul": 0,
    "pvq_matmul_q": 0,
    "pvq_attn_q": 0,
    "pvq_matmul_batched": 0,
    "pvq_matmul_q_batched": 0,
}


V3_BODY_LAUNCHES: Dict[str, int] = {"splitk": 0, "direct": 0, "mma": 0}
V2_BODY_LAUNCHES: Dict[str, int] = {"direct": 0, "mma": 0, "splitk": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, V3_BODY_LAUNCHES, V2_BODY_LAUNCHES):
        for name in counts:
            counts[name] = 0


def launches() -> Dict[str, int]:
    return dict(LAUNCHES)


def v3_body_launches() -> Dict[str, int]:
    return dict(V3_BODY_LAUNCHES)


def v2_body_launches() -> Dict[str, int]:
    return dict(V2_BODY_LAUNCHES)
