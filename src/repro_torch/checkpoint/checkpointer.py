"""Checkpointing: atomic, async, restart-safe; optional PVQ-compressed
weight storage (PyTorch port of ``repro.checkpoint.checkpointer``).

Layout: ``<dir>/step_<N>/`` with one ``.npy`` per leaf (flat-keyed), a
``manifest.json`` and a ``COMMIT`` marker written last: restore trusts
committed steps only, so a crash mid-write is never restored from.

A state is nested dicts, tuples and ``AdamWState``s of tensors,
``PackedPVQ`` leaves and host ints.  Its flat keys are the reference's
(JAX's key paths): a dict key, a tuple index, ``.<field>`` for an
``AdamWState`` field, ``/``-joined, in JAX's order (dict keys sorted,
tuple and field order kept).  So ``(params, opt_state)`` writes
``0/embed/embedding``, ``1/.step``, ``1/.mu/...``, ``1/.nu/...``, and a
directory the port writes from the reference's state is the reference's,
file for file and byte for byte, but for ``COMMIT``'s timestamp.  A host
int (the port's ``AdamWState.step``) is stored as the reference's 0-d
int32 array; a bf16 leaf as float32 with ``"stored_dtype"`` (numpy has no
bf16), as the reference does.

``PackedPVQ`` leaves are stored as the code, never the dequantized weights:
``packed_codec='packed'`` writes int8 pulses (nibble-packed when every
``|pulse| <= 7``) and f32 scales (codec ``pvq-packed``); ``'golomb'`` the
pulse tensor as a chunked signed exp-Golomb bitstream (``core.bitstream``,
codec ``pvq-golomb``).  Either restores the identical ``PackedPVQ``.
``compress='pvq'`` also re-encodes dense float matrices (rank >= 2, at
least ``min_compress_size`` elements) as PVQ codes on save and dequantizes
them on restore: lossy for those weights (the paper's trade), bit-exact for
everything else (moments, step counters).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core import bitstream
from ..core.codes import golomb_encode
from ..core.packed import PackedPVQ, is_packed
from ..core.packing import pack_nibbles, unpack_nibbles
from ..core.pvq import pvq_encode_grouped


def _children(tree: Any):
    """``(key, child)`` pairs of a node in JAX's flatten order, or None for
    a leaf."""
    if isinstance(tree, dict):
        return [(str(key), tree[key]) for key in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple
        return [(f".{name}", getattr(tree, name)) for name in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(str(i), sub) for i, sub in enumerate(tree)]
    return None


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """{path: leaf} in JAX's order (dict keys sorted); leaves as they are,
    packed leaves whole."""
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    flat: Dict[str, Any] = {}
    for key, sub in kids:
        flat.update(_flatten(sub, f"{prefix}/{key}" if prefix else key))
    return flat


def _unflatten_into(tree: Any, flat: Dict[str, Any], prefix: str = "") -> Any:
    """``tree``'s structure with every leaf taken from ``flat``: packed
    leaves as they are (on the target leaf's device), arrays and tensors
    cast to the target leaf's dtype and device and reshaped to its shape,
    and a host int target as an int."""
    def path(key):
        return f"{prefix}/{key}" if prefix else key

    if isinstance(tree, dict):
        return {key: _unflatten_into(sub, flat, path(str(key))) for key, sub in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten_into(getattr(tree, name), flat, path(f".{name}"))
                            for name in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten_into(sub, flat, path(str(i))) for i, sub in enumerate(tree))
    leaf = flat[prefix]
    if is_packed(leaf):
        return leaf.to(tree.pulses.device if is_packed(tree) else tree.device)
    if isinstance(tree, int):
        return int(np.asarray(leaf))
    if isinstance(leaf, np.ndarray):
        leaf = torch.from_numpy(np.ascontiguousarray(leaf))
    return leaf.to(device=tree.device, dtype=tree.dtype).reshape(tree.shape)


def _host(leaf: Any) -> Any:
    """A leaf's copy off the card: a CPU tensor, a CPU ``PackedPVQ``, or a
    host int as the reference's 0-d int32 step counter."""
    if is_packed(leaf):
        return PackedPVQ(pulses=leaf.pulses.to("cpu", copy=True),
                         scales=leaf.scales.to("cpu", copy=True), group=leaf.group, k=leaf.k,
                         shape=leaf.shape, dtype=leaf.dtype, layout=leaf.layout,
                         scale_mode=leaf.scale_mode)
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.asarray(leaf)


def _numpy(leaf) -> Tuple[np.ndarray, str]:
    """``(array, dtype name)``; a bf16 tensor comes back as float32 under
    its own name."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.to(torch.float32).numpy(), "bfloat16"
        arr = leaf.numpy()
        return arr, str(arr.dtype)
    return leaf, str(leaf.dtype)


class Checkpointer:
    def __init__(
        self,
        directory: str | Path,
        *,
        keep: int = 3,
        compress: Optional[str] = None,  # None | 'pvq'
        packed_codec: str = "packed",  # 'packed' | 'golomb'
        pvq_n_over_k: float = 1.0,
        pvq_group: int = 256,
        min_compress_size: int = 4096,
    ):
        if packed_codec not in ("packed", "golomb"):
            raise ValueError(f"packed_codec must be 'packed' or 'golomb', got {packed_codec!r}")
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.compress = compress
        self.packed_codec = packed_codec
        self.pvq_n_over_k = pvq_n_over_k
        self.pvq_group = pvq_group
        self.min_compress_size = min_compress_size
        self._async_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save

    def save(self, step: int, state: Any, *, block: bool = True) -> Path:
        """Write the checkpoint of ``step``.  The state is copied off the
        card before this returns; with ``block=False`` the files are written
        on a thread (asynchronous checkpointing: the step loop runs on)."""
        host_state = {key: _host(leaf) for key, leaf in _flatten(state).items()}
        if block:
            return self._write(step, host_state)
        self.wait()
        self._async_thread = threading.Thread(target=self._write, args=(step, host_state),
                                              daemon=True)
        self._async_thread.start()
        return self.dir / f"step_{step:09d}"

    def wait(self):
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    def _write(self, step: int, flat: Dict[str, Any]) -> Path:
        final = self.dir / f"step_{step:09d}"
        tmp = self.dir / f".tmp_step_{step:09d}_{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest: Dict[str, Any] = {"step": step, "leaves": {}, "compress": self.compress}
        for key, arr in flat.items():
            fname = key.replace("/", "__")
            if is_packed(arr):
                self._write_packed(tmp, fname, key, arr, manifest)
                continue
            arr, dtype = _numpy(arr)
            entry: Dict[str, Any] = {"shape": list(arr.shape), "dtype": dtype}
            is_float = dtype in ("float32", "float16", "bfloat16")
            if (
                self.compress == "pvq"
                and arr.ndim >= 2
                and arr.size >= self.min_compress_size
                and is_float
            ):
                code = pvq_encode_grouped(
                    torch.from_numpy(np.asarray(arr, np.float32).reshape(-1)),
                    group=self.pvq_group,
                    k=max(int(round(self.pvq_group / self.pvq_n_over_k)), 1),
                    scale_mode="ls",
                )
                pulses = code.pulses.numpy()
                if np.abs(pulses).max(initial=0) <= 7:
                    packed, pshape = pack_nibbles(pulses)
                    np.save(tmp / f"{fname}.pulses.npy", packed)
                    entry["pulse_format"] = "nibble"
                    entry["pulse_shape"] = list(pshape)
                else:
                    np.save(tmp / f"{fname}.pulses.npy", pulses.astype(np.int8))
                    entry["pulse_format"] = "int8"
                    entry["pulse_shape"] = list(pulses.shape)
                np.save(tmp / f"{fname}.scales.npy", code.scale.numpy().astype(np.float32))
                entry["codec"] = "pvq"
                entry["k"] = int(code.k)
                entry["group"] = self.pvq_group
                # report-only entropy estimate (bits/weight under Golomb)
                _, nbits = golomb_encode(pulses.ravel()[: min(pulses.size, 65536)])
                entry["golomb_bits_per_weight_est"] = nbits / min(pulses.size, 65536)
            else:
                save_arr = arr
                if dtype == "bfloat16":
                    entry["stored_dtype"] = "float32"
                np.save(tmp / f"{fname}.npy", save_arr)
                entry["codec"] = "raw"
            manifest["leaves"][key] = entry
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        (tmp / "COMMIT").write_text(str(time.time()))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()
        return final

    def _write_packed(self, tmp: Path, fname: str, key: str, arr: PackedPVQ,
                      manifest: Dict[str, Any]) -> None:
        """A ``PackedPVQ`` leaf as its code: restore is bit-exact, with no
        re-encode."""
        pulses = arr.pulses.numpy().astype(np.int8)
        entry = {
            "pulse_shape": list(pulses.shape),
            "scales_shape": list(arr.scales.shape),
            "group": int(arr.group),
            "k": int(arr.k),
            "shape": list(arr.shape),
            "dtype": arr.dtype,
            "layout": arr.layout,
            "scale_mode": arr.scale_mode,
        }
        if self.packed_codec == "golomb":
            # the paper's §VI entropy coding at rest
            blob, info = bitstream.encode_pulses(pulses, "golomb")
            (tmp / f"{fname}.pulses.bin").write_bytes(blob)
            entry["codec"] = "pvq-golomb"
            entry["pulse_info"] = info
        elif np.abs(pulses).max(initial=0) <= 7:
            packed_bits, _ = pack_nibbles(pulses)
            np.save(tmp / f"{fname}.pulses.npy", packed_bits)
            entry["codec"] = "pvq-packed"
            entry["pulse_format"] = "nibble"
        else:
            np.save(tmp / f"{fname}.pulses.npy", pulses)
            entry["codec"] = "pvq-packed"
            entry["pulse_format"] = "int8"
        np.save(tmp / f"{fname}.scales.npy", arr.scales.numpy().astype(np.float32))
        manifest["leaves"][key] = entry

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # --------------------------------------------------------------- restore

    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "COMMIT").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target: Any, step: Optional[int] = None) -> Tuple[Any, int]:
        """Restore into the structure, dtypes and devices of ``target``;
        returns ``(state, step)``."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no committed checkpoints under {self.dir}")
        d = self.dir / f"step_{step:09d}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat: Dict[str, Any] = {}
        for key, entry in manifest["leaves"].items():
            fname = key.replace("/", "__")
            if entry["codec"] in ("pvq-packed", "pvq-golomb"):
                if entry["codec"] == "pvq-golomb":
                    blob = (d / f"{fname}.pulses.bin").read_bytes()
                    pulses = bitstream.decode_pulses(blob, entry["pulse_info"]).reshape(
                        entry["pulse_shape"]
                    ).astype(np.int8)
                elif entry["pulse_format"] == "nibble":
                    raw = np.load(d / f"{fname}.pulses.npy")
                    pulses = unpack_nibbles(raw, tuple(entry["pulse_shape"])).astype(np.int8)
                else:
                    pulses = np.load(d / f"{fname}.pulses.npy").astype(np.int8)
                scales = np.load(d / f"{fname}.scales.npy").astype(np.float32)
                flat[key] = PackedPVQ(
                    pulses=torch.from_numpy(pulses),
                    scales=torch.from_numpy(scales.reshape(entry["scales_shape"])),
                    group=int(entry["group"]),
                    k=int(entry["k"]),
                    shape=tuple(entry["shape"]),
                    dtype=entry["dtype"],
                    layout=entry["layout"],
                    scale_mode=entry["scale_mode"],
                )
            elif entry["codec"] == "pvq":
                raw = np.load(d / f"{fname}.pulses.npy")
                if entry["pulse_format"] == "nibble":
                    pulses = unpack_nibbles(raw, tuple(entry["pulse_shape"]))
                else:
                    pulses = raw.astype(np.int64)
                scales = np.load(d / f"{fname}.scales.npy")
                w = (pulses.astype(np.float32) * scales[..., None]).reshape(-1)
                n = int(np.prod(entry["shape"]))
                flat[key] = w[:n].reshape(entry["shape"])
            else:
                flat[key] = np.load(d / f"{fname}.npy")
        return _unflatten_into(target, flat), step
