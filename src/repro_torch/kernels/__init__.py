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

The wrappers count on the host, where they launch.  A CUDA graph replays
its kernels without them, so a captured step records what its capture
counted (``snapshot`` before, ``since`` after), takes it back
(``add(delta, -1)``: a capture launches nothing) and adds it on every
replay: the counts keep meaning launches on the card, the same for a
captured run as for an eager one.
"""

from typing import Dict, Tuple

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

_COUNTS = (LAUNCHES, V3_BODY_LAUNCHES, V2_BODY_LAUNCHES)
Counts = Tuple[Dict[str, int], ...]


def reset_launches() -> None:
    for counts in _COUNTS:
        for name in counts:
            counts[name] = 0


def snapshot() -> Counts:
    """A copy of every launch count."""
    return tuple(dict(c) for c in _COUNTS)


def since(before: Counts) -> Counts:
    """Each count's change since ``before`` (a :func:`snapshot`)."""
    return tuple({k: c[k] - b[k] for k in c} for c, b in zip(_COUNTS, before))


def add(delta: Counts, times: int = 1) -> None:
    """Add ``times`` x ``delta`` (a :func:`since`) to the counts."""
    for counts, d in zip(_COUNTS, delta):
        for name, n in d.items():
            counts[name] += times * n


def launches() -> Dict[str, int]:
    return dict(LAUNCHES)


def v3_body_launches() -> Dict[str, int]:
    return dict(V3_BODY_LAUNCHES)


def v2_body_launches() -> Dict[str, int]:
    return dict(V2_BODY_LAUNCHES)
