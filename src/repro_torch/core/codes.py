"""Entropy-coding size models and codecs for PVQ pulse vectors (paper §VI).

The paper proposes, in order of practicality:
  * fixed-length enumeration codes  -> ``repro_torch.core.enumeration``
  * signed exponential-Golomb codes  (1 bit for 0, 3 for +/-1, 5 for +/-2..3,
    7 for +/-4..7, ... — exactly the ladder used in the paper's Table-5
    arithmetic: FC0 of net A averages ~1.4 bits/weight)
  * run-length coding of zero runs (N/K ~ 5 -> >= 4/5 zeros guaranteed)
  * Huffman with an escape code for |v| > V

This module implements bit-exact encoders/decoders for Golomb and RLE (used by
the ``.pvqz`` pulse streams) and size estimators for all schemes.

The PyTorch port's copy of ``repro.core.codes``: numpy only, the same
bits on the same inputs.
"""

from __future__ import annotations

import heapq
from collections import Counter
from typing import Dict, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# signed exp-Golomb (order 0), zigzag mapping  v -> u:  0,+1,-1,+2,-2 -> 0,1,2,3,4
# ---------------------------------------------------------------------------


def zigzag(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, dtype=np.int64)
    return np.where(v > 0, 2 * v - 1, -2 * v)


def unzigzag(u: np.ndarray) -> np.ndarray:
    u = np.asarray(u, dtype=np.int64)
    t = (u + 1) >> 1  # == |v| for both parities (u >= 0 by construction)
    return np.where(u & 1, t, -t)


def golomb_length(v: np.ndarray) -> np.ndarray:
    """Code length in bits of signed exp-Golomb order 0 for each value."""
    u = zigzag(v)
    return 2 * np.floor(np.log2(u + 1)).astype(np.int64) + 1


def golomb_encode(values: np.ndarray) -> Tuple[bytes, int]:
    """Bit-exact encoder. Returns (blob, nbits)."""
    u = zigzag(np.asarray(values).ravel())
    bits = []
    for x in u.tolist():
        x1 = x + 1
        nb = x1.bit_length()
        bits.append("0" * (nb - 1) + format(x1, "b"))
    stream = "".join(bits)
    nbits = len(stream)
    if nbits == 0:
        return b"", 0
    stream_padded = stream + "0" * ((8 - nbits % 8) % 8)
    blob = int(stream_padded, 2).to_bytes(len(stream_padded) // 8, "big")
    return blob, nbits


def golomb_decode(blob: bytes, nbits: int, count: int) -> np.ndarray:
    stream = bin(int.from_bytes(blob, "big"))[2:].zfill(len(blob) * 8)[:nbits] if blob else ""
    out = []
    i = 0
    for _ in range(count):
        z = 0
        while stream[i] == "0":
            z += 1
            i += 1
        x1 = int(stream[i : i + z + 1], 2)
        i += z + 1
        out.append(x1 - 1)
    return unzigzag(np.asarray(out, dtype=np.int64))


# ---------------------------------------------------------------------------
# zero run-length + Golomb values (good fit for N/K >= 5 FC layers)
# ---------------------------------------------------------------------------


def rle_flat_pairs(values: np.ndarray) -> np.ndarray:
    """Interleaved (zero-run, nonzero-value) pair stream of ``values``.

    Vectorized: one pair per nonzero (zeros preceding it, then the value),
    plus — when the vector ends in zeros — a terminator pair with value 0
    (invalid as a nonzero).  Returns the flat int64 symbol stream
    ``[run0, v0, run1, v1, ...]`` of length ``2 * n_pairs``.
    """
    v = np.asarray(values, dtype=np.int64).ravel()
    nz = np.flatnonzero(v)
    runs = np.diff(np.concatenate([np.asarray([-1]), nz])) - 1
    vals = v[nz]
    trailing = v.size - (int(nz[-1]) + 1 if nz.size else 0)
    if trailing:
        runs = np.concatenate([runs, np.asarray([trailing])])
        vals = np.concatenate([vals, np.asarray([0])])
    flat = np.empty(2 * runs.size, dtype=np.int64)
    flat[0::2] = runs
    flat[1::2] = vals
    return flat


def rle_bits(values: np.ndarray) -> int:
    """Exact bit count of :func:`rle_encode` without building the stream —
    the size model the artifact codec chooser and ``packed_stats`` use."""
    flat = rle_flat_pairs(values)
    return int(golomb_length(flat).sum()) if flat.size else 0


def rle_encode(values: np.ndarray) -> Tuple[bytes, int, int]:
    """(zero-run, nonzero-value) pair stream; both exp-Golomb coded.

    Returns (blob, nbits, n_pairs). A final run with no trailing value is
    encoded as a pair with value 0 (invalid as a nonzero, acts as terminator).
    """
    flat = rle_flat_pairs(values)
    blob, nbits = golomb_encode(flat)
    return blob, nbits, flat.size // 2


def rle_decode(blob: bytes, nbits: int, n_pairs: int, total: int) -> np.ndarray:
    flat = golomb_decode(blob, nbits, 2 * n_pairs)
    out = []
    for i in range(n_pairs):
        run, val = int(flat[2 * i]), int(flat[2 * i + 1])
        out.extend([0] * run)
        if val != 0:
            out.append(val)
    out.extend([0] * (total - len(out)))
    return np.asarray(out, dtype=np.int64)


# ---------------------------------------------------------------------------
# Huffman-with-escape size model (paper's practical table scheme)
# ---------------------------------------------------------------------------


def huffman_escape_bits(values: np.ndarray, v_max: int = 7, escape_payload_bits: int = 16) -> float:
    """Average bits/value of a Huffman code over {-v_max..v_max} + ESC."""
    v = np.asarray(values).ravel()
    inlier = np.abs(v) <= v_max
    counts = Counter(v[inlier].tolist())
    n_esc = int((~inlier).sum())
    if n_esc:
        counts["ESC"] = n_esc
    if len(counts) == 1:
        return 1.0
    heap = [(c, i, sym) for i, (sym, c) in enumerate(counts.items())]
    heapq.heapify(heap)
    depth: Dict = {sym: 0 for sym in counts}
    groups = {i: [sym] for i, (sym, _) in enumerate(counts.items())}
    next_id = len(groups)
    heap = [(c, i) for i, (sym, c) in enumerate(counts.items())]
    heapq.heapify(heap)
    while len(heap) > 1:
        c1, g1 = heapq.heappop(heap)
        c2, g2 = heapq.heappop(heap)
        for sym in groups[g1] + groups[g2]:
            depth[sym] += 1
        groups[next_id] = groups.pop(g1) + groups.pop(g2)
        heapq.heappush(heap, (c1 + c2, next_id))
        next_id += 1
    total_bits = sum(counts[sym] * depth[sym] for sym in counts)
    total_bits += n_esc * escape_payload_bits
    return total_bits / max(len(v), 1)


# ---------------------------------------------------------------------------
# Reports
# ---------------------------------------------------------------------------


def pulse_histogram(values: np.ndarray) -> Dict[str, float]:
    """Bucketized stats exactly as in the paper's Tables 5-8."""
    v = np.abs(np.asarray(values).ravel())
    n = max(v.size, 1)
    buckets = {
        "0": int((v == 0).sum()),
        "+-1": int((v == 1).sum()),
        "+-2..3": int(((v >= 2) & (v <= 3)).sum()),
        "+-4..7": int(((v >= 4) & (v <= 7)).sum()),
        "others": int((v > 7).sum()),
    }
    out = {}
    for k_, c in buckets.items():
        out[k_] = c
        out[k_ + "_pct"] = 100.0 * c / n
    return out


def compression_report(values: np.ndarray, n: int | None = None, k: int | None = None) -> Dict[str, float]:
    """Bits/weight under each §VI scheme (+ fixed enumeration bound if n,k given)."""
    v = np.asarray(values).ravel()
    count = max(v.size, 1)
    golomb_bits = float(golomb_length(v).sum()) / count
    _, rle_nbits, _ = rle_encode(v)
    report = {
        "golomb_bits_per_weight": golomb_bits,
        "rle_bits_per_weight": rle_nbits / count,
        "huffman_esc_bits_per_weight": huffman_escape_bits(v),
        "raw_int8_bits_per_weight": 8.0,
    }
    if n is not None and k is not None and n <= 4096:
        from .enumeration import index_bits

        report["enumeration_bits_per_weight"] = index_bits(n, k) / n
    return report
