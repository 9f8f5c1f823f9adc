"""The ``.pvqz`` single-file compressed artifact (PyTorch port of
``repro.checkpoint.artifact``, paper §VI end to end).

``PackedPVQ`` is the in-memory deployment format, int8 pulses + f32 group
scales.  This module is the at-rest half: the pulse streams are
entropy-coded (``repro_torch.core.bitstream``, numpy on the host) down to
the paper's ~1.4-2.7 bits/weight, packed into one seekable container, and
decoded leaf by leaf straight back into ``PackedPVQ`` on the card:
identical pulses and scales, no re-encode, peak host memory bounded by the
largest single leaf.  A file written by either package loads into the
other, and both write the same bytes from the same packed parameters.

File layout (all integers little-endian)::

    [magic b"PVQZ" | u8 version | 3 reserved bytes]
    [leaf blob 0][leaf blob 1]...          # written sequentially
    [TOC: json, utf-8]
    [footer: u64 toc_offset | u64 toc_len | magic b"ZPVQ"]

The TOC carries one record per leaf: path, kind (``packed`` | ``raw``),
blob offset/size, CRC32, and for packed leaves the full ``PackedPVQ``
static metadata plus the pulse-codec info and a separate scales section
(raw ``<f4``, CRC'd).  Readers parse the footer, then seek per leaf.
Leaves go in sorted path order (``checkpointer._flatten``).

Pulse streams cover only the *logical* weight region: the group-padding
rows of the matmul layout (and the tail padding of the flat layout) are
dropped on encode and rebuilt as zeros on decode.  The fixed-length
enumeration codec is the exception: it codes whole (G, group) rows,
padded groups included.  ``codec="auto"`` prices every candidate with the
exact size models (``bitstream.measured_bits``) and takes the cheapest.

Raw bfloat16 leaves are stored as float32 (``dtype: "bfloat16"``,
``stored_dtype: "float32"``); every other raw leaf as it is.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..core import bitstream
from ..core.bitstream import (  # noqa: F401  (re-exported API)
    PULSE_CODECS,
    choose_codec,
)
from ..core.packed import (
    PackedPVQ,
    dtype_name,
    is_packed,
    pulse_groups,
    pulse_stream,
    torch_dtype,
)
from .checkpointer import _flatten, _unflatten_into

MAGIC = b"PVQZ"
END_MAGIC = b"ZPVQ"
VERSION = 1
_FOOTER = struct.Struct("<QQ4s")


def _note_codec(op: str, codec: str, n_symbols: int, seconds: float) -> None:
    """Per-codec entropy-coding throughput metrics (``op`` is ``encode`` or
    ``decode``; ``n_symbols`` = int8 pulse symbols moved).  No-op unless the
    telemetry registry is enabled."""
    from ..runtime import obs

    if not obs.enabled():
        return
    labels = {"codec": codec}
    obs.counter(f"artifact.{op}_leaves", labels).inc()
    obs.counter(f"artifact.{op}_symbols", labels).add(n_symbols)
    obs.counter(f"artifact.{op}_s", labels).add(seconds)
    if seconds > 0:
        obs.histogram(f"artifact.{op}_mb_s", labels).record(n_symbols / seconds / 1e6)


# ---------------------------------------------------------------------------
# pulse layout <-> stream transforms
# ---------------------------------------------------------------------------


def _logical_numel(pk: PackedPVQ) -> int:
    lead = pk.pulses.shape[: pk.pulses.ndim - 2]
    return int(np.prod(lead, initial=1)) * int(np.prod(pk.shape))


def _unstream(
    flat: np.ndarray, layout: str, pulse_shape: Tuple[int, ...], shape: Tuple[int, ...]
) -> np.ndarray:
    """Inverse of :func:`pulse_stream`: rebuild the physical int8 tensor,
    structural padding re-materialized as zeros."""
    if layout == "matmul":
        *lead, k_pad, n = pulse_shape
        d_in = int(shape[-2])
        arr = np.asarray(flat, np.int64).reshape(*lead, n, d_in)
        out = np.zeros((*lead, n, k_pad), np.int64)
        out[..., :d_in] = arr
        return np.swapaxes(out, -1, -2).astype(np.int8)
    *lead, g, group = pulse_shape
    numel = int(np.prod(shape))
    out = np.zeros((*lead, g * group), np.int64)
    out[..., :numel] = np.asarray(flat, np.int64).reshape(*lead, numel)
    return out.reshape(*pulse_shape).astype(np.int8)


def _groups_to_physical(
    groups: np.ndarray, layout: str, pulse_shape: Tuple[int, ...]
) -> np.ndarray:
    if layout == "matmul":
        *lead, k_pad, n = pulse_shape
        return np.swapaxes(groups.reshape(*lead, n, k_pad), -1, -2).astype(np.int8)
    return groups.reshape(*pulse_shape).astype(np.int8)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


def _raw_host(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(host array, dtype name) of a raw leaf; the name is the reference's
    (``float32``, ``bfloat16``, ...), never ``str(torch.dtype)``."""
    t = leaf.detach()
    if t.dtype == torch.bfloat16:  # numpy has no bfloat16: its f32 values
        return t.to(torch.float32).cpu().numpy(), "bfloat16"
    return t.cpu().numpy(), dtype_name(t.dtype)


def write_pvqz(
    path: str | Path,
    params: Any,
    *,
    codec: str = "auto",
    chunk: Optional[int] = None,
    meta: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Encode a (mixed) parameter tree into a ``.pvqz`` file.

    ``PackedPVQ`` leaves (on any device) get entropy-coded pulse streams +
    raw f32 scales; every other leaf is stored raw (bf16 as f32).  ``codec``
    is one of :data:`PULSE_CODECS` or ``"auto"`` (per-leaf cheapest by
    measured bits).  Returns the compression report: per-leaf codec and
    bits/weight and artifact-level totals.

    Writes go through a tmp file + atomic rename: a mid-write crash (or an
    encode error) never truncates or corrupts an existing good artifact,
    and a failed write leaves no tmp behind.
    """
    path = Path(path)
    tmp_path = path.with_name(f".{path.name}.tmp{os.getpid()}")
    try:
        report = _write_pvqz_file(tmp_path, params, codec=codec, chunk=chunk, meta=meta)
    except BaseException:
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        raise
    os.replace(tmp_path, path)
    report["path"] = str(path)
    return report


def _write_pvqz_file(
    tmp_path: Path,
    params: Any,
    *,
    codec: str,
    chunk: Optional[int],
    meta: Optional[Dict[str, Any]],
) -> Dict[str, Any]:
    flat = _flatten(params)
    report_leaves: Dict[str, Dict[str, Any]] = {}
    toc: Dict[str, Any] = {"version": VERSION, "meta": meta or {}, "leaves": []}
    packed_payload_bits = 0.0
    packed_scale_bits = 0.0
    packed_numel = 0
    replaced_dense_bytes = 0
    with open(tmp_path, "wb") as f:
        f.write(MAGIC + bytes([VERSION]) + b"\0\0\0")
        for key, leaf in flat.items():
            rec: Dict[str, Any] = {"path": key}
            if is_packed(leaf):
                leaf = leaf.to("cpu")  # one copy off the card for both views
                pulses_shape = tuple(int(s) for s in leaf.pulses.shape)
                stream = pulse_stream(leaf)
                groups = pulse_groups(leaf)
                if codec == "auto":
                    leaf_codec, sizes = choose_codec(stream, groups, leaf.k)
                else:
                    leaf_codec = codec
                    _, sizes = choose_codec(stream, groups, leaf.k)
                symbols = groups if leaf_codec == "enum" else stream
                t_enc = time.perf_counter()
                blob, info = bitstream.encode_pulses(symbols, leaf_codec, k_max=leaf.k, chunk=chunk)
                enc_s = time.perf_counter() - t_enc
                _note_codec("encode", leaf_codec, int(symbols.size), enc_s)
                scales = np.ascontiguousarray(
                    leaf.scales.to(torch.float32).numpy(), dtype="<f4"
                )
                sblob = scales.tobytes()
                rec.update(
                    kind="packed",
                    offset=f.tell(),
                    nbytes=len(blob),
                    crc32=zlib.crc32(blob),
                    pulse_info=info,
                    group=int(leaf.group),
                    k=int(leaf.k),
                    shape=[int(s) for s in leaf.shape],
                    dtype=leaf.dtype,
                    layout=leaf.layout,
                    scale_mode=leaf.scale_mode,
                    pulse_shape=list(pulses_shape),
                    scales_shape=list(scales.shape),
                    # leading stack axes (layer stack, MoE expert axis):
                    # per-stack-entry group geometry is (shape[-2] rows ->
                    # pulse_shape[-2] group-padded rows) x shape[-1] columns
                    stack=list(pulses_shape[: len(pulses_shape) - 2]),
                )
                f.write(blob)
                rec["scales_offset"] = f.tell()
                rec["scales_nbytes"] = len(sblob)
                rec["scales_crc32"] = zlib.crc32(sblob)
                f.write(sblob)
                numel = _logical_numel(leaf)
                payload_bits = info["nbits"]
                scale_bits = 32 * scales.size
                packed_payload_bits += payload_bits
                packed_scale_bits += scale_bits
                packed_numel += numel
                replaced_dense_bytes += leaf.nbytes_dense
                report_leaves[key] = {
                    "codec": leaf_codec,
                    "numel": numel,
                    "pulse_bits": int(payload_bits),
                    "bits_per_weight": round((payload_bits + scale_bits) / max(numel, 1), 4),
                    "candidate_bits_per_weight": {
                        c: round(b / max(numel, 1), 4) for c, b in sizes.items()
                    },
                    "encode_s": round(enc_s, 4),
                    "encode_mb_s": round(int(symbols.size) / max(enc_s, 1e-9) / 1e6, 3),
                }
            else:
                arr, orig_dtype = _raw_host(leaf)
                stored_dtype = orig_dtype
                if orig_dtype == "bfloat16":
                    arr = arr.astype(np.float32)
                    stored_dtype = "float32"
                blob = np.ascontiguousarray(arr).tobytes()
                rec.update(
                    kind="raw",
                    offset=f.tell(),
                    nbytes=len(blob),
                    crc32=zlib.crc32(blob),
                    shape=list(arr.shape),
                    dtype=orig_dtype,
                    stored_dtype=stored_dtype,
                )
                f.write(blob)
                report_leaves[key] = {"codec": "raw", "nbytes": len(blob)}
            toc["leaves"].append(rec)
        toc_offset = f.tell()
        toc_blob = json.dumps(toc).encode()
        f.write(toc_blob)
        f.write(_FOOTER.pack(toc_offset, len(toc_blob), END_MAGIC))
        file_bytes = f.tell()
    return {
        "file_bytes": file_bytes,
        "packed_numel": packed_numel,
        "packed_payload_bits": int(packed_payload_bits),
        "packed_scale_bits": int(packed_scale_bits),
        "bits_per_weight": round(
            (packed_payload_bits + packed_scale_bits) / max(packed_numel, 1), 4
        ),
        "replaced_dense_bytes": replaced_dense_bytes,
        "compression_vs_dense": round(
            8.0 * replaced_dense_bytes / max(packed_payload_bits + packed_scale_bits, 1.0), 2
        ),
        "leaves": report_leaves,
    }


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


def read_toc(path: str | Path) -> Dict[str, Any]:
    with open(path, "rb") as f:
        head = f.read(8)
        if head[:4] != MAGIC:
            raise ValueError(f"{path}: not a .pvqz file (bad magic {head[:4]!r})")
        if head[4] != VERSION:
            raise ValueError(f"{path}: unsupported .pvqz version {head[4]}")
        f.seek(-_FOOTER.size, 2)
        toc_offset, toc_len, end = _FOOTER.unpack(f.read(_FOOTER.size))
        if end != END_MAGIC:
            raise ValueError(f"{path}: truncated .pvqz (bad end magic)")
        f.seek(toc_offset)
        return json.loads(f.read(toc_len).decode())


def _read_checked(f, offset: int, nbytes: int, crc: int, what: str) -> bytes:
    f.seek(offset)
    blob = f.read(nbytes)
    if len(blob) != nbytes or zlib.crc32(blob) != crc:
        raise ValueError(f"CRC mismatch in {what} (corrupt .pvqz)")
    return blob


def _read_packed_blobs(f, rec: Dict[str, Any]) -> Tuple[bytes, bytes]:
    """File half of the packed-leaf decode: seeks + CRC checks, main thread."""
    blob = _read_checked(f, rec["offset"], rec["nbytes"], rec["crc32"], f"pulses of {rec['path']}")
    sblob = _read_checked(
        f, rec["scales_offset"], rec["scales_nbytes"], rec["scales_crc32"],
        f"scales of {rec['path']}",
    )
    return blob, sblob


def _decode_packed_np(
    blob: bytes, sblob: bytes, rec: Dict[str, Any]
) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy half of the packed-leaf decode (no torch, no file handle):
    safe to run on the prefetch worker thread.  Returns C-contiguous,
    writable arrays."""
    info = rec["pulse_info"]
    pulse_shape = tuple(rec["pulse_shape"])
    t_dec = time.perf_counter()
    if info["codec"] == "enum":
        groups = bitstream.decode_pulses(blob, info, rec["group"])
        pulses = _groups_to_physical(groups, rec["layout"], pulse_shape)
    else:
        flat = bitstream.decode_pulses(blob, info)
        pulses = _unstream(flat, rec["layout"], pulse_shape, tuple(rec["shape"]))
    pulses = np.ascontiguousarray(pulses)
    _note_codec("decode", info["codec"], int(pulses.size), time.perf_counter() - t_dec)
    scales = np.frombuffer(sblob, "<f4").reshape(rec["scales_shape"]).astype(np.float32)
    return pulses, scales


def _place_packed(rec: Dict[str, Any], pulses: np.ndarray, scales: np.ndarray,
                  device) -> PackedPVQ:
    """Device-placement half: the host-to-device copies stay on the main thread."""
    return PackedPVQ(
        pulses=torch.from_numpy(pulses).to(device),
        scales=torch.from_numpy(scales).to(device),
        group=int(rec["group"]),
        k=int(rec["k"]),
        shape=tuple(int(s) for s in rec["shape"]),
        dtype=rec["dtype"],
        layout=rec["layout"],
        scale_mode=rec["scale_mode"],
    )


def _decode_raw(f, rec: Dict[str, Any], device) -> torch.Tensor:
    blob = _read_checked(f, rec["offset"], rec["nbytes"], rec["crc32"], rec["path"])
    arr = np.frombuffer(blob, dtype=np.dtype(rec["stored_dtype"])).reshape(rec["shape"])
    t = torch.from_numpy(arr.copy())  # frombuffer is read-only
    if rec["dtype"] != rec["stored_dtype"]:
        t = t.to(torch_dtype(rec["dtype"]))
    return t.to(device)


def iter_pvqz(
    path: str | Path, *, prefetch: bool = True, device="cuda"
) -> Iterator[Tuple[str, Any]]:
    """Stream (path_key, leaf) pairs, decoding ONE leaf at a time.

    Packed leaves come back as ``PackedPVQ`` on ``device`` with the pulses
    and scales that were exported (no re-encode anywhere); raw leaves as
    tensors on ``device`` in their original dtype.  Peak host decode memory
    is bounded by the largest single leaf (the prefetch keeps at most one
    extra decoded leaf in flight).

    With ``prefetch`` (the default) the numpy entropy decode of the next
    leaf overlaps the device placement of the current one: one worker
    thread runs :func:`_decode_packed_np` while the main thread does the
    file reads, CRC checks and the copies to ``device``.  Exceptions from
    the worker surface at the corresponding yield.
    """
    toc = read_toc(path)
    if not prefetch:
        with open(path, "rb") as f:
            for rec in toc["leaves"]:
                if rec["kind"] == "packed":
                    blob, sblob = _read_packed_blobs(f, rec)
                    yield rec["path"], _place_packed(rec, *_decode_packed_np(blob, sblob, rec),
                                                     device)
                else:
                    yield rec["path"], _decode_raw(f, rec, device)
        return
    from concurrent.futures import Future, ThreadPoolExecutor

    with open(path, "rb") as f, ThreadPoolExecutor(
        max_workers=1, thread_name_prefix="pvqz-decode"
    ) as pool:
        pending: list[Tuple[Dict[str, Any], Any]] = []

        def emit(rec: Dict[str, Any], ready: Any) -> Tuple[str, Any]:
            if isinstance(ready, Future):
                return rec["path"], _place_packed(rec, *ready.result(), device)
            return rec["path"], ready

        for rec in toc["leaves"]:
            if rec["kind"] == "packed":
                blob, sblob = _read_packed_blobs(f, rec)
                pending.append((rec, pool.submit(_decode_packed_np, blob, sblob, rec)))
            else:
                pending.append((rec, _decode_raw(f, rec, device)))
            while len(pending) > 1:  # keep exactly one decode in flight
                yield emit(*pending.pop(0))
        while pending:
            yield emit(*pending.pop(0))


def load_pvqz(path: str | Path, target: Optional[Any] = None, device="cuda") -> Any:
    """Load a ``.pvqz`` into a parameter tree on ``device``.

    With ``target`` (e.g. ``model.init(...)`` params), leaves are restored
    into its structure, raw ones cast to its dtypes and devices (the
    serving entry point).  Without it, returns a nested dict keyed by the
    stored slash paths.
    """
    flat = dict(iter_pvqz(path, device=device))
    if target is not None:
        return _unflatten_into(target, flat)
    nested: Dict[str, Any] = {}
    for key, leaf in flat.items():
        node = nested
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return nested
