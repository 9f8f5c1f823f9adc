"""Autotuner for the port's Hopper kernels (port of ``repro.kernels.autotune``).

The kernels take their tiles at run time, and four rules pick them today:
``pvq_matmul._v3_body`` / ``_v2_body`` (kernel v3's and v2's body: splitk,
mma or direct), ``_v3_decode_plan`` (the splitk bodies' k chunk),
``_v4_plan`` (kernel v4's query rows ``km`` and blocks a pass ``w``) and
``pvq_encode.DELTA_MAX`` (the encoder's exact greedy tail).  This module
times the choices each kernel already takes on the card, keeps the fastest
in a JSON cache, and serves it to ``kernels.ops`` on every call.  Every
choice is exact against the kernel's plain version (v3, v4 and the
encoder's kernel bit for bit, v2 one f64 group dot rounded once), so a
tuned matmul or attention choice changes no output bit; a tuned
``delta_max`` only ever raises the greedy tail above the rule's 32.

Cache
-----
* location: ``$REPRO_TORCH_PVQ_TUNE_CACHE`` if set, else
  ``~/.cache/repro_torch/pvq_tune_cache.json`` (apart from the reference's
  cache); writes are atomic (a temp file, then ``os.replace``), and a
  memory mirror is reloaded only when the path changes.
* matmul key: ``"m x k x n : g<group> : <dtype> : <backend> : kv<N> :
  <schema>"`` (no spaces), plus ``":e<E>"`` for an expert-batched call (the
  splitk plan depends on the expert count).  ``kv<N>`` is
  ``pvq_matmul.KERNEL_VERSION``; ``<dtype>`` is the activation dtype:
  ``int8`` keys time kernel v3, ``float32``/``bfloat16`` keys kernel v2;
  ``<backend>`` is ``cpu`` or the card's name, spaces replaced by ``_``.
  Value ``{"body", "chunk", "us", "candidates", ...}`` (``chunk`` 0 for the
  bodies that do not split k).
* attention key (kernel v4): ``"attn m x hd x s : g<group> : int8 :
  <backend> : kv<N> : <schema>"``; value ``{"km", "w", "us", "candidates",
  ...}``.
* encoder key: ``"enc g x n : k<K> : <dtype> : <backend> : ekv<N> :
  <schema>"`` (``pvq_encode.ENCODE_KERNEL_VERSION``); value
  ``{"delta_max", "us", "candidates", ...}``.  The reference's ``bg`` (its
  VMEM tile of group rows) has no counterpart here: the encoder runs one
  warp a row, four rows a CTA.
* Every value also holds the search's medians and spreads (interquartile
  range) of the winner and of the rule's choice: ``spread_us``, ``rule``,
  ``rule_us``, ``rule_spread_us``.

Dispatch (``get_tiles``, ``get_attn_tiles``, ``get_encode_params``): a cache
hit wins; else, if searching is on (``search=True`` or
``REPRO_TORCH_PVQ_AUTOTUNE=1``) and no CUDA stream is capturing, a search
runs and persists; else the rule decides (no timing, no I/O).  A captured
graph keeps the choice it was captured with.

Timing: operands from a seeded ``torch.Generator`` on the device; each
candidate runs once untimed, then ``reps`` times, each launch between CUDA
events with the L2 flushed before it, all queued behind a sleep kernel so
the host's own time stays out; the median wins (the rule's choice, first
in every list, on a tie).  On the CPU the one candidate is the rule's
choice, timed through the plain version.  The timing launches are taken
back out of the launch counts.
"""

from __future__ import annotations

import json
import logging
import os
import statistics
import tempfile
import time
from functools import lru_cache
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch

from ..runtime import obs
from . import add, since, snapshot
from . import pvq_encode as enc
from . import pvq_matmul as mm
from .pvq_encode import ENCODE_KERNEL_VERSION
from .pvq_matmul import KERNEL_VERSION

CACHE_ENV = "REPRO_TORCH_PVQ_TUNE_CACHE"
SEARCH_ENV = "REPRO_TORCH_PVQ_AUTOTUNE"
# the port's own key schema (its cache file is not the reference's)
_SCHEMA = "v1"
# process-local mirror of the JSON file, and the path it was read from
_MEM: Dict[str, dict] = {}
_MEM_LOADED_FROM: Optional[str] = None

#: launches a candidate is timed over, on the card and on the CPU
REPS = 10
CPU_REPS = 3
#: bytes zeroed before each timed launch (the H100's L2 is 50 MB)
L2_FLUSH_BYTES = 96 * 2**20
#: sleep-kernel cycles queued per timed launch, so the host enqueues every
#: launch before the card reaches the first
SLEEP_CYCLES_PER_REP = 1_000_000
_FLUSH: Dict[int, torch.Tensor] = {}


def cache_path() -> Path:
    env = os.environ.get(CACHE_ENV, "").strip()
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro_torch" / "pvq_tune_cache.json"


@lru_cache(maxsize=None)
def _card_name(index: int) -> str:
    return torch.cuda.get_device_name(index).replace(" ", "_")


def backend(device) -> str:
    """``cpu``, or the card's name with spaces replaced by ``_``."""
    d = torch.device(device)
    if d.type != "cuda":
        return d.type
    return _card_name(d.index if d.index is not None else torch.cuda.current_device())


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def cache_key(m: int, k: int, n: int, group: int, dtype, backend: str,
              e: Optional[int] = None) -> str:
    key = f"{m}x{k}x{n}:g{group}:{_dtype_name(dtype)}:{backend}:kv{KERNEL_VERSION}:{_SCHEMA}"
    return key if e is None else f"{key}:e{e}"


def attn_cache_key(m: int, hd: int, s: int, group: int, dtype, backend: str) -> str:
    return (f"attn{m}x{hd}x{s}:g{group}:{_dtype_name(dtype)}:{backend}"
            f":kv{KERNEL_VERSION}:{_SCHEMA}")


def encode_cache_key(g: int, n: int, k_pulses: int, dtype, backend: str) -> str:
    return (f"enc{g}x{n}:k{k_pulses}:{_dtype_name(dtype)}:{backend}"
            f":ekv{ENCODE_KERNEL_VERSION}:{_SCHEMA}")


def _load() -> Dict[str, dict]:
    """Read-through memory mirror of the JSON file."""
    global _MEM, _MEM_LOADED_FROM
    path = str(cache_path())
    if _MEM_LOADED_FROM == path:
        return _MEM
    entries: Dict[str, dict] = {}
    try:
        with open(path) as f:
            raw = json.load(f)
        if isinstance(raw, dict):
            entries = {k: v for k, v in raw.items() if isinstance(v, dict)}
    except (OSError, json.JSONDecodeError):
        entries = {}
    _MEM, _MEM_LOADED_FROM = entries, path
    return _MEM


def _persist(key: str, entry: dict) -> None:
    """Read-modify-write with an atomic replace (tuning may run concurrently)."""
    global _MEM_LOADED_FROM
    path = cache_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        with open(path) as f:
            current = json.load(f)
        if not isinstance(current, dict):
            current = {}
    except (OSError, json.JSONDecodeError):
        current = {}
    current[key] = entry
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(current, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
    _load()[key] = entry
    _MEM_LOADED_FROM = str(path)


def clear_memory_cache() -> None:
    """Forget the in-process mirror (tests point the cache path around)."""
    global _MEM, _MEM_LOADED_FROM
    _MEM = {}
    _MEM_LOADED_FROM = None


# ---------------------------------------------------------------------------
# tuning observability: hit/miss/search counts + search wall-time, per key
# ---------------------------------------------------------------------------

_LOG = logging.getLogger("repro_torch.autotune")
_PLURAL = {"hit": "hits", "miss": "misses", "search": "searches"}


def _fresh_stats() -> Dict[str, object]:
    return {"hits": 0, "misses": 0, "searches": 0, "search_s": 0.0, "by_key": {}}


_TUNE_STATS: Dict[str, object] = _fresh_stats()


def tune_stats() -> Dict[str, object]:
    """Copy of the process tuning stats: total/per-key hit, miss, and
    completed-search counts plus accumulated search wall-time (seconds)."""
    out = dict(_TUNE_STATS)
    out["search_s"] = round(float(out["search_s"]), 4)
    out["by_key"] = {k: dict(v) for k, v in _TUNE_STATS["by_key"].items()}
    return out


def reset_tune_stats() -> None:
    global _TUNE_STATS
    _TUNE_STATS = _fresh_stats()


def _note(key: str, outcome: str, search_s: float = 0.0) -> None:
    """Record one cache lookup outcome (``hit``/``miss``) or completed
    ``search``; logs it and mirrors into the telemetry registry.  Runs on
    every dispatch, on the host only (during a capture too)."""
    word = _PLURAL[outcome]
    _TUNE_STATS[word] += 1
    if search_s:
        _TUNE_STATS["search_s"] += search_s
    per = _TUNE_STATS["by_key"].setdefault(key, {"hits": 0, "misses": 0, "searches": 0})
    per[word] += 1
    if outcome == "search":
        _LOG.info("search done for %s in %.3fs", key, search_s)
    else:
        _LOG.debug("cache %s: %s", outcome, key)
    if obs.enabled():
        if outcome != "search":
            obs.counter("autotune.lookups").inc()
        obs.counter(f"autotune.{outcome}").inc()
        if outcome == "search":
            obs.histogram("autotune.search_s").record(search_s)


def _search_on(search: Optional[bool]) -> bool:
    if search is None:
        search = os.environ.get(SEARCH_ENV, "") not in ("", "0", "false")
    return bool(search)


def _capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


# ---------------------------------------------------------------------------
# the rules and the candidates
# ---------------------------------------------------------------------------


def _int8(dtype) -> bool:
    return _dtype_name(dtype) == "int8"


def heuristic_tiles(m: int, k: int, n: int, group: int, dtype=torch.float32,
                    e: Optional[int] = None) -> Tuple[str, int]:
    """The rule's ``(body, chunk)`` for 16-byte aligned operands (as the
    wrappers' operands are): ``_v3_body`` for int8 activations, else
    ``_v2_body``, and ``_v3_decode_plan``'s chunk for the splitk body (0
    for the others)."""
    if _int8(dtype):
        body = mm._v3_body(m, k, n, group, 0, 0)
    else:
        body = mm._v2_body(m, k, n, group, 0, 0, getattr(torch, _dtype_name(dtype)))
    chunk = mm._v3_decode_plan(e or 1, m, k, n, group)[1] if body == "splitk" else 0
    return body, chunk


def candidate_tiles(m: int, k: int, n: int, group: int, dtype=torch.float32,
                    e: Optional[int] = None) -> Tuple[Tuple[str, int], ...]:
    """Every ``(body, chunk)`` the kernel takes at this shape, the rule's
    first, no duplicates.  At m <= 8 the splitk body with each chunk the
    splitk bodies take (``pvq_matmul._splitk_chunk_fits``) whose partials,
    written and read back, stay within the pulse bytes, and the direct
    body; above 8 rows the mma body where it fits, and the direct body."""
    cands = [heuristic_tiles(m, k, n, group, dtype, e)]
    if _int8(dtype):
        splitk_fits, mma_fits = (mm._splitk_fits(k, n, group, 0, 0),
                                 mm._mma_fits(k, n, group, 0, 0))
        partial_bytes = 4
    else:
        x_dtype = getattr(torch, _dtype_name(dtype))
        splitk_fits, mma_fits = (mm._v2_splitk_fits(k, n, group, 0, 0, x_dtype),
                                 mm._v2_mma_fits(k, n, group, 0, 0, x_dtype))
        partial_bytes = 8
    if m <= 8:
        if splitk_fits:
            chunks = [k] + [d for d in range(group, 3, -1) if group % d == 0]
            for chunk in chunks:
                if mm._splitk_chunk_fits(e or 1, k, n, group, chunk) and (
                        chunk == k or 2 * partial_bytes * m * (k // chunk) <= k):
                    cands.append(("splitk", chunk))
    elif mma_fits:
        cands.append(("mma", 0))
    cands.append(("direct", 0))
    return tuple(dict.fromkeys(cands))


def heuristic_attn_plan(m: int, hd: int, s: int, group: int) -> Tuple[int, int]:
    """The rule's ``(km, w)``: ``pvq_matmul._v4_plan``'s."""
    return mm._v4_plan(m, s, hd, group)[:2]


def attn_candidates(m: int, hd: int, s: int, group: int) -> Tuple[Tuple[int, int], ...]:
    """Every ``(km, w)`` kernel v4 takes (``_check_v4_plan``) at these
    shapes with no idle query row or block (``km <= m``, ``w`` no more than
    the blocks of ``s``), the rule's first."""
    nblk = mm._v4_blocks(s)
    cands = [heuristic_attn_plan(m, hd, s, group)]
    for km in range(1, min(m, mm.V4_KM_MAX) + 1):
        for w in range(1, min(nblk, mm.V4_WARPS_MAX // km) + 1):
            try:
                mm._check_v4_plan((km, w, -(-nblk // w)), s, hd, group)
            except ValueError:
                continue
            cands.append((km, w))
    return tuple(dict.fromkeys(cands))


#: the rule's greedy tail; candidates never go below it, so a tuned encoder
#: is at least as exact as the rule's
ENCODE_DEFAULT = enc.DELTA_MAX
ENCODE_DELTA_CANDIDATES = (32, 64)


def encode_candidates() -> Tuple[int, ...]:
    """``delta_max`` candidates, the rule's first, none below it."""
    return tuple(dict.fromkeys([ENCODE_DEFAULT] + [d for d in ENCODE_DELTA_CANDIDATES
                                                   if d >= ENCODE_DEFAULT]))


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def _time_us(call: Callable[[], object], device: torch.device, reps: int) -> Tuple[float, float]:
    """Median and interquartile range (us) of ``reps`` timed calls after one
    untimed one (see the module docstring)."""
    call()
    if device.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            call()
            times.append(1e6 * (time.perf_counter() - t0))
    else:
        with torch.cuda.device(device):
            flush = _FLUSH.get(device.index)
            if flush is None:
                flush = _FLUSH[device.index] = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                                           device=device)
            events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                      for _ in range(reps)]
            torch.cuda.synchronize(device)
            torch.cuda._sleep(SLEEP_CYCLES_PER_REP * reps)
            for start, end in events:
                flush.zero_()
                start.record()
                call()
                end.record()
            events[-1][1].synchronize()
            times = [1e3 * start.elapsed_time(end) for start, end in events]
    q = statistics.quantiles(times, n=4) if len(times) > 1 else [times[0]] * 3
    return statistics.median(times), q[2] - q[0]


def _search(key: str, cands: Sequence, call_for: Callable, device: torch.device,
            reps: Optional[int], fields: Callable[[object], dict]) -> dict:
    """Time every candidate (only the rule's on the CPU), persist and return
    the winner's entry; the timing launches leave the launch counts as they
    were."""
    t0 = time.perf_counter()
    if device.type != "cuda":
        cands = cands[:1]
    reps = reps or (REPS if device.type == "cuda" else CPU_REPS)
    before = snapshot()
    try:
        timed = [(c, *_time_us(call_for(c), device, reps)) for c in cands]
    finally:
        add(since(before), -1)
    best = min(timed, key=lambda t: t[1])  # the first of equal medians
    rule = timed[0]
    entry = {**fields(best[0]), "us": round(best[1], 3), "spread_us": round(best[2], 3),
             "candidates": len(cands), "rule": _plain(rule[0]), "rule_us": round(rule[1], 3),
             "rule_spread_us": round(rule[2], 3)}
    _persist(key, entry)
    _note(key, "search", time.perf_counter() - t0)
    return entry


def _plain(cand):
    """A candidate as JSON keeps it (tuples are lists there)."""
    return list(cand) if isinstance(cand, tuple) else cand


def _generator(device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


def _matmul_call(m, k, n, group, dtype, e, device):
    """``call_for((body, chunk))``: the kernel (the plain version on the
    CPU) on seeded operands of the key's shape."""
    gen = _generator(device)
    lead = () if e is None else (e,)
    w = torch.randint(-3, 4, (*lead, k, n), generator=gen, device=device, dtype=torch.int8)
    s = torch.rand((*lead, k // group, n), generator=gen, device=device) * 0.05
    cuda = device.type == "cuda"
    if _int8(dtype):
        x = torch.randint(-127, 128, (*lead, m, k), generator=gen, device=device,
                          dtype=torch.int8)
        a = torch.full((*lead, m, 1), 0.01, device=device)
        if e is None:
            fn = mm.pvq_matmul_q_cuda if cuda else mm.pvq_matmul_q_plain
            args = (x, w, s, a, None)
        else:
            fn = mm.pvq_matmul_q_batched_cuda if cuda else mm.pvq_matmul_q_batched_plain
            args = (x, w, s, a)
    else:
        x = torch.randn((*lead, m, k), generator=gen, device=device).to(
            getattr(torch, _dtype_name(dtype)))
        if e is None:
            fn = mm.pvq_matmul_cuda if cuda else mm.pvq_matmul_plain
            args = (x, w, s, None)
        else:
            fn = mm.pvq_matmul_batched_cuda if cuda else mm.pvq_matmul_batched_plain
            args = (x, w, s)

    def call_for(cand):
        body, chunk = cand
        kw = {"_body": body, "_chunk": chunk or None} if cuda else {}
        return lambda: fn(*args, group=group, **kw)

    return call_for


def _device(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


# ---------------------------------------------------------------------------
# matmuls (kernels v2 / v3, 2-D and expert-batched)
# ---------------------------------------------------------------------------


def autotune(m: int, k: int, n: int, *, group: int = 128, dtype=torch.float32,
             e: Optional[int] = None, reps: Optional[int] = None, device="cuda") -> dict:
    """Search :func:`candidate_tiles` for the key; persist and return the
    winning entry ``{"body", "chunk", "us", "candidates", ...}``.  A cache
    hit skips the search entirely."""
    device = _device(device)
    key = cache_key(m, k, n, group, dtype, backend(device), e)
    hit = _load().get(key)
    if hit is not None:
        _note(key, "hit")
        return hit
    _note(key, "miss")
    return _search(key, candidate_tiles(m, k, n, group, dtype, e),
                   _matmul_call(m, k, n, group, dtype, e, device), device, reps,
                   lambda c: {"body": c[0], "chunk": c[1]})


def get_tiles(m: int, k: int, n: int, *, group: int = 128, dtype=torch.float32,
              e: Optional[int] = None, search: Optional[bool] = None,
              device="cuda") -> Tuple[str, int]:
    """``(body, chunk)`` for ``ops``' matmuls: cache hit > search (never
    while a stream captures) > :func:`heuristic_tiles`."""
    device = _device(device)
    key = cache_key(m, k, n, group, dtype, backend(device), e)
    hit = _load().get(key)
    if hit is not None:
        _note(key, "hit")
        return hit["body"], int(hit["chunk"])
    if _search_on(search) and not _capturing():
        ent = autotune(m, k, n, group=group, dtype=dtype, e=e, device=device)
        return ent["body"], int(ent["chunk"])
    _note(key, "miss")
    return heuristic_tiles(m, k, n, group, dtype, e)


def tune_shapes(shapes: Iterable[Tuple[int, int, int]], *, group: int = 128,
                dtype=torch.float32, e: Optional[int] = None, reps: Optional[int] = None,
                device="cuda") -> Dict[str, dict]:
    """Pre-tune a batch of GEMM shapes (serve warm-up). Returns key -> entry."""
    device = _device(device)
    return {cache_key(m, k, n, group, dtype, backend(device), e):
            autotune(m, k, n, group=group, dtype=dtype, e=e, reps=reps, device=device)
            for m, k, n in shapes}


# ---------------------------------------------------------------------------
# attention decode (kernel v4)
# ---------------------------------------------------------------------------


def autotune_attn(m: int, hd: int, s: int, *, group: int = 32, dtype=torch.int8,
                  reps: Optional[int] = None, device="cuda", bh: int = 2) -> dict:
    """Search :func:`attn_candidates` for a ``(m, hd, s)`` decode-attention
    shape (``m`` query rows per kv head, ``s`` the planes' extent, every
    position live) over ``bh`` rows; persist and return
    ``{"km", "w", "us", "candidates", ...}``.  A cache hit skips the
    search."""
    device = _device(device)
    key = attn_cache_key(m, hd, s, group, dtype, backend(device))
    hit = _load().get(key)
    if hit is not None:
        _note(key, "hit")
        return hit
    _note(key, "miss")
    gen = _generator(device)
    ng = hd // group
    q = torch.randint(-127, 128, (bh, m, hd), generator=gen, device=device, dtype=torch.int8)
    a = torch.full((bh, m, 1), 0.01, device=device)
    kp, vp = (torch.randint(-5, 6, (bh, s, 1, hd), generator=gen, device=device,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.full((bh, s, 1, ng), 0.05, device=device) for _ in range(2))
    kv_len = torch.full((bh,), s, dtype=torch.int32, device=device)
    args = (q, a, kp, ks, vp, vs, kv_len)
    nblk = mm._v4_blocks(s)

    def call_for(cand):
        if device.type != "cuda":
            return lambda: mm.pvq_attn_q_plain(*args, group=group, sm_scale=1.0)
        plan = (*cand, -(-nblk // cand[1]))
        return lambda: mm.pvq_attn_q_cuda(*args, group=group, sm_scale=1.0, _plan=plan)

    return _search(key, attn_candidates(m, hd, s, group), call_for, device, reps,
                   lambda c: {"km": c[0], "w": c[1]})


def get_attn_tiles(m: int, hd: int, s: int, *, group: int = 32, dtype=torch.int8,
                   search: Optional[bool] = None, device="cuda") -> Tuple[int, int]:
    """``(km, w)`` for ``ops.pvq_attn_decode``: cache hit > search >
    :func:`heuristic_attn_plan`, as :func:`get_tiles`."""
    device = _device(device)
    key = attn_cache_key(m, hd, s, group, dtype, backend(device))
    hit = _load().get(key)
    if hit is not None:
        _note(key, "hit")
        return int(hit["km"]), int(hit["w"])
    if _search_on(search) and not _capturing():
        ent = autotune_attn(m, hd, s, group=group, dtype=dtype, device=device)
        return int(ent["km"]), int(ent["w"])
    _note(key, "miss")
    return heuristic_attn_plan(m, hd, s, group)


def tune_attn_shapes(shapes: Iterable[Tuple[int, ...]], *, group: int = 32, dtype=torch.int8,
                     reps: Optional[int] = None, device="cuda") -> Dict[str, dict]:
    """Pre-tune a batch of ``(m, hd, s)`` or ``(m, hd, s, bh)`` decode-attention
    shapes.  The engine keys its v4 dispatch on the slot pool's geometry:
    ``m`` query rows per kv head and ``s`` the pool extent ``max_pages *
    page``, whatever the requests in flight.  Returns key -> entry."""
    device = _device(device)
    out = {}
    for m, hd, s, *bh in shapes:
        out[attn_cache_key(m, hd, s, group, dtype, backend(device))] = autotune_attn(
            m, hd, s, group=group, dtype=dtype, reps=reps, device=device, bh=bh[0] if bh else 2)
    return out


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def autotune_encode(g: int, n: int, k_pulses: int, *, dtype=torch.float32,
                    reps: Optional[int] = None, device="cuda") -> dict:
    """Search :func:`encode_candidates` for a ``(g, n, K)`` encode shape;
    persist and return ``{"delta_max", "us", "candidates", ...}``.  A cache
    hit skips the search."""
    device = _device(device)
    key = encode_cache_key(g, n, k_pulses, dtype, backend(device))
    hit = _load().get(key)
    if hit is not None:
        _note(key, "hit")
        return hit
    _note(key, "miss")
    # Laplace rows, as the reference's search encodes
    u = torch.rand((g, n), generator=_generator(device), device=device) - 0.5
    w = (-torch.sign(u) * torch.log1p(-2 * u.abs())).to(getattr(torch, _dtype_name(dtype)))

    def call_for(delta_max):
        fn = enc.pvq_encode_batch_cuda if device.type == "cuda" else enc.pvq_encode_batch_plain
        return lambda: fn(w, k_pulses=k_pulses, delta_max=delta_max)

    return _search(key, encode_candidates(), call_for, device, reps,
                   lambda c: {"delta_max": c})


def get_encode_params(g: int, n: int, k_pulses: int, *, dtype=torch.float32,
                      search: Optional[bool] = None, device="cuda") -> int:
    """``delta_max`` for ``ops.pvq_encode``: cache hit > search >
    ``ENCODE_DEFAULT``, as :func:`get_tiles`."""
    device = _device(device)
    key = encode_cache_key(g, n, k_pulses, dtype, backend(device))
    hit = _load().get(key)
    if hit is not None:
        _note(key, "hit")
        return max(int(hit["delta_max"]), ENCODE_DEFAULT)
    if _search_on(search) and not _capturing():
        return int(autotune_encode(g, n, k_pulses, dtype=dtype, device=device)["delta_max"])
    _note(key, "miss")
    return ENCODE_DEFAULT
