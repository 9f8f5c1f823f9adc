"""Build and load the hand-written Hopper kernels.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under
``build/kernels/`` at the root of the checkout, then loaded with
``ctypes``.  All sources are compiled at once (one ``nvcc`` process per
file, started together) on the first kernel launch; a library whose source
hash is unchanged is reused.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

#: source -> extra nvcc flags.  The encoder is built without FMA
#: contraction so its float sums round exactly like the plain version's
#: elementwise adds (bit-identical pulses on the card).
SOURCES: Dict[str, tuple] = {
    "pvq_encode": ("-fmad=false",),
    "pvq_matmul": (),
    "pvq_attn": (),
}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: source -> {exported C symbol: (argtypes, restype)}; bound once, at load
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "pvq_encode": {
        "pvq_encode_launch": ([_P, _I, _I, _I, _I, _P, _P, _P], _I),
    },
    "pvq_matmul": {
        "pvq_matmul_launch": ([_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P], _I),
        "pvq_matmul_q_launch": ([_P, _P, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P], _I),
    },
    "pvq_attn": {
        "pvq_attn_q_smem_bytes": ([_I, _I, _I], ctypes.c_size_t),
        "pvq_attn_q_launch": ([_P] * 7 + [_I] * 6 + [_F, _P, _P, _P, _P], _I),
    },
}

_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_FUNCS: Dict[str, Callable] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels can only be built where the CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    flags = " ".join(SOURCES[name]).encode()
    digest = hashlib.sha256(src + flags).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all() -> Dict[str, Path]:
    """Compile every stale kernel library in parallel; returns name -> path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in SOURCES}
    procs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            nvcc_path(), *_ARCH, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", *SOURCES[name],
            "-o", str(tmp), str(CSRC / f"{name}.cu"),
        ]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp)
    failures = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        text = out.decode(errors="replace")
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return paths


def _load_all() -> None:
    """Build the stale libraries, load each once and bind its signatures."""
    for name, path in build_all().items():
        lib = ctypes.CDLL(str(path))
        for symbol, (argtypes, restype) in SIGNATURES[name].items():
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = argtypes, restype
            _FUNCS[symbol] = fn


def launcher(symbol: str) -> Callable:
    """The bound C function ``symbol`` (building and loading every kernel
    library on first use)."""
    fn = _FUNCS.get(symbol)
    if fn is None:
        with _LOCK:
            if not _FUNCS:
                _load_all()
        fn = _FUNCS[symbol]
    return fn


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launcher."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {status}")
