"""Vectorized bit-level I/O for PVQ pulse streams (paper §VI, at rest).

``repro_torch.core.codes`` carries the bit-exact *size models* and slow per-symbol
reference codecs; this module is the production path: numpy-vectorized
bit packing and **chunked** streams that decode with bounded Python overhead
regardless of leaf size (all chunks advance one symbol per vectorized round,
so a million-weight leaf costs ~``chunk`` numpy rounds, not a million).

Three stream families, all bit-exact round-trips:

* ``golomb``  — signed exp-Golomb order 0 (zigzag mapped), the paper's
  Table-5 ladder: 1 bit for 0, 3 for +/-1, 5 for +/-2..3, ...
* ``rle``     — (zero-run, nonzero-value) pairs, both Golomb coded; the
  natural fit for N/K >= 5 layers (>= 4/5 zeros guaranteed).
* ``enum``    — Fischer enumeration over sub-ladders: each group row is
  split into ``enum_sub_width(N)``-wide sub-rows; the stream is all L1
  headers (fixed width) then each sub-row's lexicographic rank within
  P(sub, k_s) in ``index_bits(sub, k_s)`` bits.  Encoded and decoded by the
  vectorized limb ladder (``repro_torch.core.enumeration``) — near-optimal length
  at bulk-numpy speed, the default-eligible codec on every leaf whose count
  tables fit memory.

Chunked streams embed their per-chunk bit-offset table in the blob header
(``[u32 n_chunks][u64 * n_chunks bit offsets][stream bytes]``) so a blob +
its info dict is self-contained; :func:`encode_pulses` / :func:`decode_pulses`
are the single entry points the ``.pvqz`` container uses.

The PyTorch port's copy of ``repro.core.bitstream``: numpy only, the same
bytes.  ``pack_nibbles`` / ``unpack_nibbles`` (the reference keeps them in
``repro.core.packing``) live here.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

import numpy as np

from .codes import golomb_length, rle_bits, rle_flat_pairs, zigzag
from .enumeration import (
    enum_supported,
    index_bits,
    index_to_vector_batch,
    limb_count,
    vector_to_index_batch,
)

DEFAULT_CHUNK = 1024

#: ladder width of the enumeration stream — group rows are split into
#: contiguous sub-rows of (at most) this many coordinates, each carrying its
#: own L1 header.  Narrower ladders decode faster (fewer sequential coordinate
#: rounds, fewer rank limbs) and the per-sub headers act as a crude adaptive
#: bit allocation, so the split *reduces* total payload bits on real leaves.
ENUM_SUB = 64

#: deterministic tie-break order for codec selection (paper §VI practicality)
PULSE_CODECS = ("golomb", "rle", "enum", "nibble", "int8")

# ---------------------------------------------------------------------------
# bit-packing primitives
# ---------------------------------------------------------------------------


def pack_nibbles(pulses: np.ndarray) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """Pack int pulses with |v| <= 7 into uint8 nibbles (lo nibble = even idx)."""
    p = np.asarray(pulses, dtype=np.int64)
    if np.abs(p).max(initial=0) > 7:
        raise ValueError("nibble packing requires |pulse| <= 7")
    shape = p.shape
    flat = p.ravel()
    if flat.size % 2:
        flat = np.concatenate([flat, np.zeros(1, np.int64)])
    u = (flat & 0xF).astype(np.uint8)  # two's complement in 4 bits
    packed = (u[0::2] | (u[1::2] << 4)).astype(np.uint8)
    return packed, shape


def unpack_nibbles(packed: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    total = int(np.prod(shape))
    lo = (packed & 0xF).astype(np.int8)
    hi = ((packed >> 4) & 0xF).astype(np.int8)
    # sign-extend 4-bit two's complement
    lo = np.where(lo > 7, lo - 16, lo)
    hi = np.where(hi > 7, hi - 16, hi)
    flat = np.empty(packed.size * 2, dtype=np.int8)
    flat[0::2] = lo
    flat[1::2] = hi
    return flat[:total].reshape(shape).astype(np.int64)


def pack_bits(codes: np.ndarray, lengths: np.ndarray) -> Tuple[np.ndarray, int]:
    """Concatenate variable-length big-endian codewords into a byte array.

    ``codes[i]`` carries the low ``lengths[i]`` bits of symbol i (MSB first on
    the wire; leading-zero bits of the codeword are part of the length).
    Vectorized over symbols: one numpy pass per bit *position* (bounded by the
    longest codeword, ~65 for int64 symbols), not per symbol.
    Returns (uint8 array from ``np.packbits``, total_bits).
    """
    codes = np.asarray(codes, dtype=np.uint64)
    lengths = np.asarray(lengths, dtype=np.int64)
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, np.uint8), 0
    starts = np.cumsum(lengths) - lengths
    bits = np.zeros(total, np.uint8)
    for j in range(int(lengths.max())):
        m = lengths > j
        shift = (lengths[m] - 1 - j).astype(np.uint64)
        bits[starts[m] + j] = ((codes[m] >> shift) & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits), total


def _bit_length(x: np.ndarray) -> np.ndarray:
    """Per-element bit length of positive int64 values (vectorized)."""
    # float64 log2 is exact-enough below 2^52: the gap to the next power of
    # two is >= 1 ulp at these magnitudes, so floor() cannot round across it.
    return (np.floor(np.log2(x.astype(np.float64))).astype(np.int64)) + 1


# ---------------------------------------------------------------------------
# chunked signed exp-Golomb
# ---------------------------------------------------------------------------


def golomb_lengths_codes(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(codes, lengths) of the signed exp-Golomb codewords for ``values``."""
    x1 = zigzag(np.asarray(values, np.int64).ravel()) + 1
    nb = _bit_length(x1)
    return x1.astype(np.uint64), 2 * nb - 1


def auto_chunk(count: int) -> int:
    """Chunk size targeting ~1.5k parallel chunks (power of two in
    [64, 4096]): decode wall time scales with the chunk length while numpy
    per-op overhead amortizes across chunks, so small streams want small
    chunks.  The choice is baked into the stream's offset table at encode
    time and travels in its info dict."""
    c = max(count // 1536, 64)
    return 1 << min(c.bit_length() - 1, 12)


def golomb_encode_chunked(
    values: np.ndarray, chunk: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Encode to one contiguous bitstream + per-chunk bit offsets.

    Returns (packed uint8 array, chunk_offsets uint64 (ceil(count/chunk),),
    total_bits, chunk).  Offsets point at the first bit of symbols 0, chunk,
    2*chunk, ... — the decoder processes all chunks in parallel.  ``chunk``
    defaults to :func:`auto_chunk` of the symbol count.
    """
    codes, lengths = golomb_lengths_codes(values)
    if chunk is None:
        chunk = auto_chunk(codes.size)
    if codes.size == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.uint64), 0, chunk
    ends = np.cumsum(lengths)
    n_chunks = -(-codes.size // chunk)
    offsets = np.concatenate([[0], ends[chunk - 1 :: chunk]])[:n_chunks]
    blob, total = pack_bits(codes, lengths)
    return blob, offsets.astype(np.uint64), total, chunk


def golomb_decode_chunked(
    blob: bytes | np.ndarray,
    chunk_offsets: np.ndarray,
    count: int,
    chunk: int = DEFAULT_CHUNK,
) -> np.ndarray:
    """Inverse of :func:`golomb_encode_chunked` (vectorized across chunks).

    Every chunk advances one symbol per round; a round is ~a dozen numpy ops
    on (n_chunks,)-sized arrays, so wall time scales with ``chunk``, not with
    ``count``.  Each round reads one big-endian 64-bit byte window per chunk
    and takes the prefix-zero count, the payload, and the unzigzagged value
    from it — no per-bit inner loop and no unpacked bit array.  The zero
    count comes from the float32 exponent of the window's top 24 bits (< 2^24
    so the conversion is exact); the rare codeword longer than 24 bits falls
    back to an exact float64 log2 on the top 32.  Chunks that run out of
    symbols keep walking a 0xFF guard tail (one bit per round, masked off by
    the final trim), which keeps the rounds branch- and mask-free.  Handles
    codewords up to 57 bits, with decoded values accumulated in int32
    (|symbol| <= 2^29 after zigzag — far beyond any pulse value or zero-run
    the RLE pair stream can produce).
    """
    if count == 0:
        return np.zeros(0, np.int64)
    u64, u32, i64 = np.uint64, np.uint32, np.int64
    if isinstance(blob, np.ndarray):
        data = np.asarray(blob, np.uint8)
    else:
        data = np.frombuffer(blob, np.uint8)
    # guard tail: exhausted chunks park here (z = 0, one bit per round) and
    # the +8 tail keeps every 8-byte window gather in bounds
    guard = -(-chunk // 8) + 8
    p = np.concatenate([data, np.full(guard, 0xFF, np.uint8)])
    # big-endian 64-bit window starting at every byte, built by doubling:
    # byte pairs -> 16-bit, pairs of those -> 32-bit, -> 64-bit (3 passes)
    m = p.size - 7
    w2 = (p[:-1].astype(np.uint16) << np.uint16(8)) | p[1:]
    w4 = (w2[: m + 4].astype(u32) << u32(16)) | w2[2 : m + 6]
    win = (w4[:m].astype(u64) << u64(32)) | w4[4 : m + 4]
    pos = np.asarray(chunk_offsets, u64).copy()
    out = np.empty((chunk, pos.size), np.int32)
    c3, c7, c23, c40, c63, c150 = u64(3), u64(7), u32(23), u64(40), u64(63), u64(150)
    for s in range(chunk):
        w = win[pos >> c3] << (pos & c7)  # stream bits from pos
        # prefix-zero count: exact float32 exponent of the top 24 bits
        f = (w >> c40).astype(u32).astype(np.float32)
        z = c150 - (f.view(u32) >> c23).astype(u64)
        bad = np.flatnonzero(z > u64(23))
        if bad.size:  # codeword longer than the 24-bit fast window
            hb = ((w[bad] >> u64(32)) | u64(1)).astype(np.float64)
            z[bad] = (31 - np.floor(np.log2(hb)).astype(i64)).astype(u64)
        # payload: drop the z prefix zeros, keep the z+1 code bits; unzigzag
        # in-round (x1 = u+1; u odd <=> x1 even <=> positive value)
        x1 = ((w << z) >> (c63 - z)).view(i64)
        out[s] = (x1 >> 1) * (1 - ((x1 & 1) << 1))
        pos += (z << u64(1)) + u64(1)
    return out.T.ravel()[:count].astype(i64)


# ---------------------------------------------------------------------------
# zero-run RLE (pairs stream, Golomb coded)
# ---------------------------------------------------------------------------


def rle_encode_chunked(
    values: np.ndarray, chunk: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, int, int, int]:
    """(blob, chunk_offsets, total_bits, n_pairs, chunk) — same pair stream
    as ``codes.rle_encode`` (and therefore the same exact size),
    chunk-decodable; ``chunk`` defaults to :func:`auto_chunk` of the *pair
    stream* length (the unit the decoder rounds over).
    """
    flat = rle_flat_pairs(values)
    blob, offsets, nbits, chunk = golomb_encode_chunked(flat, chunk)
    return blob, offsets, nbits, flat.size // 2, chunk


def rle_decode_chunked(
    blob: bytes | np.ndarray,
    chunk_offsets: np.ndarray,
    n_pairs: int,
    total: int,
    chunk: int = DEFAULT_CHUNK,
) -> np.ndarray:
    """Inverse of :func:`rle_encode_chunked`: one chunked-golomb decode of
    the pair stream (which has ~2 symbols per *nonzero*, so it is usually
    faster than a golomb stream of the same leaf), then a vectorized
    scatter of the nonzero values."""
    flat = golomb_decode_chunked(blob, chunk_offsets, 2 * n_pairs, chunk)
    runs, vals = flat[0::2], flat[1::2]
    out = np.zeros(total, np.int64)
    if n_pairs:
        pos = np.cumsum(runs) + np.arange(n_pairs)  # index of each pair's value
        has_val = vals != 0
        out[pos[has_val]] = vals[has_val]
    return out


# ---------------------------------------------------------------------------
# fixed-length Fischer enumeration stream
# ---------------------------------------------------------------------------


def enum_sub_width(n: int) -> int:
    """Ladder width the enumeration stream uses for N-wide groups.

    Groups are split into equal contiguous sub-rows of at most
    :data:`ENUM_SUB` coordinates when N divides evenly; otherwise the ladder
    runs at the full group width."""
    if n <= ENUM_SUB:
        return max(n, 1)
    s = -(-n // ENUM_SUB)
    return n // s if n % s == 0 else n


def _enum_ibits_table(sub: int, k_max: int) -> np.ndarray:
    """index_bits(sub, k) for k = 0..k_max (rank field width per L1 header)."""
    return np.asarray([index_bits(sub, t) for t in range(k_max + 1)], np.int64)


def enum_stream_bits(groups: np.ndarray, k_max: int) -> int:
    """Exact payload bits of :func:`enum_encode_groups` without encoding."""
    groups = np.asarray(groups, np.int64)
    sub = enum_sub_width(groups.shape[-1])
    k_sub = np.abs(groups.reshape(-1, sub)).sum(axis=1)
    kbits = max(int(k_max).bit_length(), 1)
    return int(k_sub.size * kbits + _enum_ibits_table(sub, k_max)[k_sub].sum())


def _extract_fields(data: np.ndarray, start: np.ndarray, width: np.ndarray):
    """Big-endian bit fields (width <= 32) out of a byte array, vectorized.

    Gathers the 5 bytes covering each field and shifts the field out; rows
    with ``width == 0`` return 0 regardless of ``start`` (which may then be
    out of range — the gather wraps harmlessly into the guard tail)."""
    d = np.concatenate([data, np.zeros(5, np.uint8)])
    start = np.maximum(start, 0)  # width-0 rows may sit before bit 0
    byte0 = start >> 3
    acc = np.zeros(start.shape, np.int64)
    for t in range(5):
        acc = (acc << 8) | d[byte0 + t]
    return (acc >> (40 - (start & 7) - width)) & ((np.int64(1) << width) - 1)


def enum_encode_groups(groups: np.ndarray, k_max: int) -> Tuple[bytes, int]:
    """Enumeration stream of a (G, N) group matrix, all groups at once.

    Each group row is split into :func:`enum_sub_width` sub-rows; every
    sub-row may sit on any pyramid P(sub, k_s) with k_s <= k_max (zero
    sub-rows and K>127-clamped groups included).  The wire format is all L1
    headers first (fixed ``max(bit_length(k_max), 1)`` bits each), then each
    sub-row's rank within P(sub, k_s) in ``index_bits(sub, k_s)`` bits,
    concatenated MSB-first and padded to a byte.  Ranks come from the
    vectorized limb ladder — no per-group Python work.  Returns
    (blob, total_bits).
    """
    groups = np.asarray(groups, np.int64)
    g, n = groups.shape
    sub = enum_sub_width(n)
    rows = groups.reshape(-1, sub)
    k_sub = np.abs(rows).sum(axis=1)
    if int(k_sub.max(initial=0)) > k_max:
        raise ValueError(
            f"group L1 {int(k_sub.max(initial=0))} exceeds k_max {k_max}"
        )
    kbits = max(int(k_max).bit_length(), 1)
    b = _enum_ibits_table(sub, k_max)[k_sub]  # per-sub rank width
    limbs = vector_to_index_batch(rows, k_max).astype(np.uint64)
    L = limbs.shape[1]
    hi = np.arange(L - 1, -1, -1)  # wire order: most significant limb first
    widths = np.clip(b[:, None] - 32 * hi[None, :], 0, 32)
    codes = np.concatenate([k_sub.astype(np.uint64), limbs[:, hi].ravel()])
    lens = np.concatenate(
        [np.full(k_sub.size, kbits, np.int64), widths.ravel()]
    )
    packed, total = pack_bits(codes, lens)
    return packed.tobytes(), total


def enum_decode_groups(
    blob: bytes, g: int, n: int, k_max: int, sub: Optional[int] = None
) -> np.ndarray:
    """Inverse of :func:`enum_encode_groups` — one vectorized pass.

    Header fields are fixed-width (one gather round), the variable-width
    rank fields are located from the header cumsum and pulled out limb by
    limb (L <= a handful of 32-bit windows per sub-row), then the whole
    (G*s, sub) rank matrix goes through the limb-ladder decode at once.
    ``sub`` pins the ladder width the blob was written with (streams carry
    it in their info dict); it defaults to the current policy."""
    sub = enum_sub_width(n) if sub is None else int(sub)
    gs = g * (n // sub)
    out = np.zeros((g, n), np.int64)
    if gs == 0:
        return out
    data = np.frombuffer(blob, np.uint8)
    kbits = max(int(k_max).bit_length(), 1)
    k_sub = _extract_fields(
        data, np.arange(gs, dtype=np.int64) * kbits, np.full(gs, kbits, np.int64)
    )
    if int(k_sub.max(initial=0)) > k_max:
        raise ValueError(f"corrupt enum stream: L1 header exceeds k_max {k_max}")
    b = _enum_ibits_table(sub, k_max)[k_sub]
    starts = gs * kbits + np.cumsum(b) - b
    L = limb_count(sub, k_max)
    j = np.arange(L)
    # all-zero sub-rows (structural group padding, fully-cancelled groups)
    # carry no rank bits and need no ladder pass: decode the live rows only
    # and scatter them back
    live = np.flatnonzero(k_sub)
    if live.size == 0:
        return out
    b, starts = b[live], starts[live]
    widths = np.clip(b[:, None] - 32 * j[None, :], 0, 32)
    ends = starts[:, None] + b[:, None] - 32 * j[None, :]
    limbs = _extract_fields(data, ends - widths, widths).astype(np.uint32)
    rows = out.reshape(gs, sub)
    rows[live] = index_to_vector_batch(limbs, k_sub[live], sub, k_max)
    return rows.reshape(g, n)


# ---------------------------------------------------------------------------
# unified pulse-stream entry points (used by .pvqz and the checkpointer)
# ---------------------------------------------------------------------------

#: chunked-stream blob header: [u32 n_chunks][u64 * n_chunks bit offsets]
_HDR_COUNT = struct.Struct("<I")


def _wrap_chunked(stream: np.ndarray, offsets: np.ndarray) -> bytes:
    return (
        _HDR_COUNT.pack(offsets.size)
        + offsets.astype("<u8").tobytes()
        + stream.tobytes()
    )


def _unwrap_chunked(blob: bytes) -> Tuple[np.ndarray, bytes]:
    (n_chunks,) = _HDR_COUNT.unpack_from(blob, 0)
    off_end = 4 + 8 * n_chunks
    offsets = np.frombuffer(blob[4:off_end], "<u8")
    return offsets, blob[off_end:]


def encode_pulses(
    values: np.ndarray,
    codec: str,
    *,
    k_max: Optional[int] = None,
    chunk: Optional[int] = None,
) -> Tuple[bytes, Dict]:
    """Encode a pulse stream (any shape; ``enum`` needs (G, N) groups).

    Returns (blob, info); ``info`` holds everything :func:`decode_pulses`
    needs besides the blob itself: codec, count, payload bits, and
    codec-specific fields.  Codecs: ``golomb`` / ``rle`` (chunked, embedded
    offset table), ``enum`` (fixed length, needs ``k_max`` and a 2-D group
    matrix), ``nibble`` / ``int8`` (raw fallbacks).
    """
    groups = np.asarray(values, np.int64)
    flat = groups.ravel()
    info: Dict = {"codec": codec, "count": int(flat.size)}
    if codec == "golomb":
        stream, offsets, nbits, chunk = golomb_encode_chunked(flat, chunk)
        info.update(nbits=int(nbits), chunk=int(chunk))
        return _wrap_chunked(stream, offsets), info
    if codec == "rle":
        stream, offsets, nbits, n_pairs, chunk = rle_encode_chunked(flat, chunk)
        info.update(nbits=int(nbits), chunk=int(chunk), n_pairs=int(n_pairs))
        return _wrap_chunked(stream, offsets), info
    if codec == "enum":
        if k_max is None:
            raise ValueError("enum codec needs k_max")
        if groups.ndim != 2:
            raise ValueError("enum codec needs a (G, N) group matrix")
        blob, total = enum_encode_groups(groups, k_max)
        info.update(
            nbits=int(total),
            k_max=int(k_max),
            n_groups=int(groups.shape[0]),
            group=int(groups.shape[1]),
            sub=enum_sub_width(int(groups.shape[1])),
        )
        return blob, info
    if codec == "nibble":
        if np.abs(flat).max(initial=0) > 7:
            raise ValueError("nibble codec requires |pulse| <= 7")
        packed, _ = pack_nibbles(flat)
        info["nbits"] = 4 * int(flat.size)
        return packed.tobytes(), info
    if codec == "int8":
        info["nbits"] = 8 * int(flat.size)
        return flat.astype(np.int8).tobytes(), info
    raise ValueError(f"unknown pulse codec {codec!r}")


def decode_pulses(blob: bytes, info: Dict, group: Optional[int] = None) -> np.ndarray:
    """Inverse of :func:`encode_pulses`.

    Returns the flat int64 symbol stream, reshaped to (G, group) when
    ``group`` is given (``enum`` blobs are always grouped).
    """
    codec, count = info["codec"], info["count"]
    if codec == "golomb":
        offsets, stream = _unwrap_chunked(blob)
        flat = golomb_decode_chunked(stream, offsets, count, info["chunk"])
    elif codec == "rle":
        offsets, stream = _unwrap_chunked(blob)
        flat = rle_decode_chunked(
            stream, offsets, info["n_pairs"], count, info["chunk"]
        )
    elif codec == "enum":
        return enum_decode_groups(
            blob, info["n_groups"], info["group"], info["k_max"],
            sub=info.get("sub"),
        )
    elif codec == "nibble":
        flat = unpack_nibbles(np.frombuffer(blob, np.uint8), (count,))
    elif codec == "int8":
        flat = np.frombuffer(blob, np.int8).astype(np.int64)[:count]
    else:
        raise ValueError(f"unknown pulse codec {codec!r}")
    return flat.reshape(-1, group) if group is not None else flat


def measured_bits(
    stream: np.ndarray,
    *,
    group_matrix: Optional[np.ndarray] = None,
    k_max: Optional[int] = None,
) -> Dict[str, float]:
    """Exact payload bits under each codec (the .pvqz selection rule input).

    ``stream`` is the symbol stream the variable-length codecs would encode
    (golomb/rle/nibble/int8); ``group_matrix``/``k_max`` additionally price
    the enumeration stream over the (G, N) group view.  All entries are
    *exact*: the ``golomb_length`` sum, the RLE pair model, and the
    enumeration header + per-sub-row rank widths are identical to the
    produced streams.
    """
    flat = np.asarray(stream, np.int64).ravel()
    out = {
        "golomb": float(golomb_length(flat).sum()) if flat.size else 0.0,
        "rle": float(rle_bits(flat)),
        "int8": 8.0 * flat.size,
    }
    if np.abs(flat).max(initial=0) <= 7:
        out["nibble"] = 4.0 * flat.size
    if group_matrix is not None and k_max is not None:
        sub = enum_sub_width(int(group_matrix.shape[-1]))
        if enum_supported(sub, int(k_max)) and int(
            np.abs(group_matrix).reshape(-1, sub).sum(axis=1).max(initial=0)
        ) <= int(k_max):
            out["enum"] = float(enum_stream_bits(group_matrix, int(k_max)))
    return out


def choose_codec(
    stream: np.ndarray,
    groups: np.ndarray,
    k: int,
) -> Tuple[str, Dict[str, float]]:
    """Pick the cheapest codec by measured payload bits — THE ``.pvqz``
    per-leaf selection rule (also applied by ``packed_stats`` so its report
    matches what the artifact actually produces).

    Returns (codec, {codec: bits}).  Every priced codec is eligible:
    enumeration runs on the vectorized limb ladder, so there is no bigint
    work budget anymore — it is only absent when its precomputed count
    tables would not fit :data:`repro_torch.core.enumeration.ENUM_TABLE_MAX_BYTES`
    (or the limb ladder's float-proxy width cap) at the leaf's sub-ladder
    geometry, which :func:`measured_bits` already accounts for.
    """
    sizes = measured_bits(stream, group_matrix=groups, k_max=k)
    codec = min(sizes, key=lambda c: (sizes[c], PULSE_CODECS.index(c)))
    return codec, sizes
