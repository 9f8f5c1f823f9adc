"""Continuous-batching serve engine over the PVQ-packed artifact (port of
``repro.launch.engine``).

The fixed-batch ``serve.generate`` loop decodes a lockstep batch: every
sequence starts together and ends together.  This engine serves a fixed
pool of ``n_slots`` decode slots that sequences join and leave mid-flight,
with the PVQ-compressed KV cache paged through a shared physical pool:

admission -> batcher -> page table -> prefill/decode steps

* **Admission**: an asyncio feeder releases :class:`Request`s into the
  pending queue at their (Poisson) arrival times; :meth:`PVQEngine.run`'s
  loop admits from the queue head whenever a slot and the prompt's full
  pages are free (FIFO; backpressure is the queue waiting).
* **Paged KV**: each attention layer's cache is a
  :class:`~repro_torch.core.packed.PagedKV`, a pool of physical pages of
  one KV block each, packed at rest.  The host-side :class:`PageAllocator`
  owns the free list; the device sees the page table and the pages the
  step's completing slots write, in static buffers every layer shares,
  refilled before every step.
* **Prefill/decode disaggregation**: prompts run through
  ``Model.prefill_bucketed`` (padded to a page-multiple bucket, with a
  dense cache under ``kv_quant_scope(None)``); the prefilled KV is then
  grafted into the pool: complete blocks PVQ-encoded into their pages
  (the encode ``PackedKV.from_dense`` does on the fixed-batch path), the
  partial block into the slot's tail ring.  Decode runs one step over the
  whole slot pool with per-slot positions.
* **Chunked prefill and prefix cache**: with ``prefill_chunk`` a long
  prompt streams through ``Model.prefill_chunk`` one chunk per engine
  step, interleaved with decode; its packed context is read back through
  kernel v4.  Full prompt pages are indexed by a chain hash, so a request
  sharing a prefix maps the pages another request wrote.
* **Eviction**: when a decode step needs more pages than the pool has,
  the youngest active sequence is evicted and requeued at the head, its
  generated tokens kept.

* **Captured steps**: on a card the engine's four steps are replays of
  CUDA graphs (``launch.capture``), the counterparts of the reference's
  jitted ``_decode_fn``, ``_prefill_fn``, ``_graft_fn`` and ``_chunk_fn``.
  Every input sits in static device buffers refilled with one copy to the
  device a step, and every index (slot, start, page ids, real lengths,
  positions) is read on the device, never on the host.  Decode: one graph
  that encodes nothing and one for the steps in which some slot completes a
  block, which encodes every slot's ring and scatters the rings of the rest
  to the trash page (``PagedKV.append(fill=True)``).  Prefill and graft: a
  graph each a bucket, at ``prefill_batch`` rows (an admission of fewer
  rows repeats row 0, as the reference pads; the repeated graft writes the
  same bytes to the same pages and ring); the graft graph reads the prefill
  graph's outputs, so it replays right after it.  Chunk: one graph.  The
  graft and the chunk encode every block and scatter the blocks past the
  context to the trash page (``PagedKV.graft_chunk`` at device indices).
  The argmax runs inside the prefill, chunk and decode graphs; the tokens
  come back to the host once a step, for the scheduler.  On the CPU the
  same bodies run eagerly; ``eager=True`` runs the host-index steps
  instead (only the real blocks and completing rings encoded, at the same
  padded shapes).  ``trace_counts`` holds the reference's keys and counts
  captures: ``warmup`` captures the decode graphs, every bucket it visits
  and the chunk graph; a context re-admitted into a new bucket captures in
  the run, as the reference retraces.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.packed import PackedPVQ, is_paged_kv
from ..core.quantize import default_act_quant, default_kv_quant, kv_quant_scope
from ..runtime import obs
from ..runtime.telemetry import Histogram
from .capture import CapturedStep


def bucket_len(n: int, multiple: int) -> int:
    """Round ``n`` up to a positive multiple: the engine's prefill buckets
    and ``serve.generate``'s cache-length buckets."""
    m = max(int(multiple), 1)
    return max(m, -(-int(n) // m) * m)


# ---------------------------------------------------------------------------
# Host-side page allocator
# ---------------------------------------------------------------------------


class PageAllocator:
    """Refcounted free-list allocator over the physical KV page pool, with
    a prompt-prefix hash index for shared-prefix page reuse.

    Page ids are ``0 .. n_pages-1``; id ``n_pages`` is the device-side
    trash page and is never handed out.  Double frees and trash frees
    raise.

    ``alloc`` hands a page out at refcount 1; ``share`` maps an
    already-written page into another slot (refcount + 1); ``free``
    decrements, and a page leaves the used set only at refcount 0.  Pages
    are immutable once written (appends and chunk grafts only target
    freshly allocated pages), so sharing is copy-on-write by construction.

    ``register`` binds a page to the chain hash of its prompt-block content
    (from position 0: content and absolute position).  A registered page
    whose refcount drops to 0 parks in a *cached* LRU pool: still
    shareable, and reclaimed LRU-first when the free list runs dry
    (``available`` counts both).
    """

    def __init__(self, n_pages: int):
        if n_pages < 1:
            raise ValueError(f"need at least one page, got {n_pages}")
        self.n_pages = int(n_pages)
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self._refs: Dict[int, int] = {}
        self._cached: "OrderedDict[int, str]" = OrderedDict()  # pid -> key, LRU order
        self._prefix: Dict[str, int] = {}  # chain hash -> pid
        self._keys: Dict[int, str] = {}  # pid -> registered chain hash

    @property
    def trash(self) -> int:
        return self.n_pages

    @property
    def available(self) -> int:
        """Pages allocatable now: the free list plus the cached pool."""
        return len(self._free) + len(self._cached)

    @property
    def used(self) -> int:
        """Pages with a live owner (refcount >= 1)."""
        return len(self._refs)

    @property
    def cached(self) -> int:
        """Refcount-0 pages parked for prefix reuse."""
        return len(self._cached)

    def refcount(self, pid: int) -> int:
        return self._refs.get(int(pid), 0)

    def alloc(self) -> Optional[int]:
        if self._free:
            pid = self._free.pop()
        elif self._cached:
            # reclaim the least recently parked prefix page; its index
            # entry dies with it (the content is about to be overwritten)
            pid, key = self._cached.popitem(last=False)
            self._prefix.pop(key, None)
            self._keys.pop(pid, None)
        else:
            return None
        self._refs[pid] = 1
        return pid

    def alloc_many(self, n: int) -> Optional[List[int]]:
        if self.available < n:
            return None
        return [self.alloc() for _ in range(n)]

    def free(self, ids: Sequence[int]) -> None:
        for pid in ids:
            pid = int(pid)
            if pid == self.trash:
                raise ValueError("freeing the trash page")
            rc = self._refs.get(pid)
            if rc is None:
                raise ValueError(f"double free of page {pid}")
            if rc > 1:
                self._refs[pid] = rc - 1
                continue
            del self._refs[pid]
            key = self._keys.get(pid)
            if key is not None and self._prefix.get(key) == pid:
                self._cached[pid] = key  # park for prefix reuse
            else:
                self._free.append(pid)

    def register(self, pid: int, key: str) -> None:
        """Bind a live page to its prompt-block chain hash.  First writer
        wins: a key already mapped to another page stays put."""
        pid = int(pid)
        if pid == self.trash or pid not in self._refs:
            return
        if key in self._prefix and self._prefix[key] != pid:
            return
        old = self._keys.get(pid)
        if old is not None and old != key:
            self._prefix.pop(old, None)
        self._prefix[key] = pid
        self._keys[pid] = key

    def lookup(self, key: str) -> Optional[int]:
        return self._prefix.get(key)

    def share(self, pid: int) -> bool:
        """Take a reference on an indexed page (live or cached); False if
        it was reclaimed in the meantime."""
        pid = int(pid)
        if pid in self._refs:
            self._refs[pid] += 1
            return True
        if pid in self._cached:
            del self._cached[pid]
            self._refs[pid] = 1
            return True
        return False


# ---------------------------------------------------------------------------
# Requests and traces
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Request:
    """One generation request plus its engine-owned progress and timing.

    After an eviction ``generated`` keeps everything produced so far; the
    re-admission prefills ``prompt + generated[:-1]`` and resumes decoding
    with ``generated[-1]`` as the pending input token."""

    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    arrival: float = 0.0  # seconds offset within the trace
    generated: List[int] = dataclasses.field(default_factory=list)
    submit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    evictions: int = 0
    # seconds spent waiting in the pending queue (first wait and every
    # post-eviction wait)
    queue_wait_s: float = 0.0
    # seconds from each eviction to the end of its re-admission, summed
    evict_cost_s: float = 0.0
    evict_t: Optional[float] = None  # in-flight eviction timestamp
    # TTFT decomposition: queue_wait_s + prefill_compute_s + chunk_wait_s
    # ~= first_token_t - submit_t
    admit_t: Optional[float] = None
    prefill_compute_s: float = 0.0
    chunk_wait_s: float = 0.0
    # pages mapped from the shared-prefix cache
    prefix_hit_pages: int = 0

    @property
    def done(self) -> bool:
        if len(self.generated) >= self.max_new_tokens:
            return True
        return (
            bool(self.generated)
            and self.eos_id is not None
            and self.generated[-1] == self.eos_id
        )


def poisson_trace(
    n_requests: int,
    *,
    rate: float,
    vocab: int,
    prompt_lens: Tuple[int, int] = (8, 24),
    max_new: int = 16,
    eos_id: Optional[int] = None,
    seed: int = 0,
    shared_prefix: int = 0,
) -> List[Request]:
    """Poisson request trace: exponential inter-arrival gaps at ``rate``
    requests/second and prompt lengths uniform in ``prompt_lens = (lo,
    hi)``; ``rate`` 0 or inf puts every arrival at t=0.  ``shared_prefix >
    0`` prepends one common random prefix of that length to every prompt.
    The same numpy ``default_rng`` draws as the reference's, so one seed
    gives both packages the same trace."""
    rng = np.random.default_rng(seed)
    lo, hi = prompt_lens
    prefix = (
        [int(x) for x in rng.integers(0, vocab, int(shared_prefix))]
        if shared_prefix
        else []
    )
    t = 0.0
    out = []
    for rid in range(n_requests):
        if rate and np.isfinite(rate) and rate > 0:
            t += float(rng.exponential(1.0 / rate))
        plen = int(rng.integers(lo, hi + 1))
        out.append(
            Request(
                rid=rid,
                prompt=prefix + [int(x) for x in rng.integers(0, vocab, plen)],
                max_new_tokens=int(max_new),
                eos_id=eos_id,
                arrival=t,
            )
        )
    return out


@dataclasses.dataclass
class _Slot:
    req: Request
    length: int  # cache rows currently filled for this slot
    pages: List[int]  # physical pages owned or shared, in logical-block order
    admit_order: int
    # chunked prefill: a slot admitted via the chunked path starts in phase
    # "prefill" and flips to "decode" when chunk_pos reaches len(ctx)
    phase: str = "decode"
    ctx: Optional[List[int]] = None  # admission context being prefilled
    chunk_pos: int = 0  # next absolute position to compute
    block_keys: Optional[List[str]] = None  # prefix chain hash per full block


def param_device(params) -> torch.device:
    """The device of the first tensor (or packed leaf) of a parameter tree."""
    if isinstance(params, dict):
        for sub in params.values():
            dev = param_device(sub)
            if dev is not None:
                return dev
        return None
    if isinstance(params, PackedPVQ):
        return params.pulses.device
    if isinstance(params, torch.Tensor):
        return params.device
    return None


def _paged_leaves(cache) -> List:
    """Every ``PagedKV`` of a model cache (nested dicts and lists)."""
    if is_paged_kv(cache):
        return [cache]
    if isinstance(cache, dict):
        return [leaf for sub in cache.values() for leaf in _paged_leaves(sub)]
    if isinstance(cache, list):
        return [leaf for sub in cache for leaf in _paged_leaves(sub)]
    return []


def _argmax_last(logits: torch.Tensor) -> np.ndarray:
    """Greedy token of each row's last position, on the host (syncs)."""
    return torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def check_engine_model(cfg) -> None:
    """Raises ``NotImplementedError`` for a configuration the engine cannot
    serve: an enc-dec model (the paged slot pool holds plain attention
    blocks only, no cross-attention cache), a VLM (a request carries
    tokens, no patch prefix), or a model with a mixer the page pool has no
    form for (RWKV's and Mamba's recurrent state, MLA's latent cache).  The
    reference's engine fails on all of them too, later:
    ``NotImplementedError`` from its paged cache (``init_block_cache``),
    ``KeyError: 'patches'`` in its prefill."""
    if cfg.encoder_layers or cfg.family == "encdec":
        raise NotImplementedError(
            f"PVQEngine: {cfg.name} is enc-dec: the paged slot-pool cache supports plain "
            "attention blocks only, not cross-attention")
    if cfg.prefix_len or cfg.family == "vlm":
        raise NotImplementedError(
            f"PVQEngine: {cfg.name} is a VLM: the engine's requests carry tokens only, "
            "no patch prefix")
    mixer = ("rwkv" if cfg.rwkv is not None else "mamba" if cfg.hybrid_period
             else "mla" if cfg.mla is not None else None)
    if mixer is not None:
        raise NotImplementedError(
            f"PVQEngine: {cfg.name} has {mixer} blocks: the paged slot-pool cache supports "
            "plain attention blocks only")


class PVQEngine:
    """Continuous-batching decode over a paged, PVQ-compressed KV cache.

    Requires an active process-wide ``KVQuant`` (pages are the PVQ KV
    blocks), the switch the fixed-batch ``serve --kv-pvq`` path uses.  The
    cache lives on the parameters' device: a CUDA model runs every kernel
    of the path on the card, a CPU model their plain versions.

    Slot invariant: an active slot holds ``length`` cache rows (prompt plus
    every generated token but the newest), and the next decode step feeds
    ``req.generated[-1]`` at position ``length``.

    The decode, prefill, graft and chunk steps are captured on a card and
    run eagerly on the CPU, both over static buffers at device indices
    (``eager=True``: the host-index steps).
    """

    def __init__(
        self,
        model,
        params,
        *,
        n_slots: int = 4,
        max_len: int = 128,
        n_pages: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        prefill_batch: int = 1,
        prefix_cache: bool = True,
        eager: bool = False,
    ):
        check_engine_model(model.cfg)
        kvq = default_kv_quant()
        if kvq is None:
            raise ValueError(
                "PVQEngine pages the PVQ-compressed cache: set a process-wide "
                "KVQuant first (set_default_kv_quant / kv_quant_scope)"
            )
        self.page = int(kvq.block)
        if self.page < 2:
            raise ValueError("page (= kv block) must be >= 2")
        self.model = model
        self.params = params
        self.device = param_device(params)
        self.n_slots = int(n_slots)
        self.max_pages = bucket_len(max_len, self.page) // self.page
        full = self.n_slots * self.max_pages
        self.n_pages = int(n_pages) if n_pages else full
        if self.n_pages < self.max_pages:
            # a lone sequence must always be able to run to max_len, or
            # eviction could never free enough pages to make progress
            raise ValueError(
                f"n_pages={self.n_pages} < max_pages={self.max_pages}: "
                "one full-length sequence must fit the pool"
            )
        # chunked prefill: prompts longer than one chunk stream in
        # C = prefill_chunk * page tokens per engine step
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk else None
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.chunk_tokens = (self.prefill_chunk or 0) * self.page
        # batched admission: up to prefill_batch same-bucket waiting
        # requests prefill in one multi-row call
        self.prefill_batch = max(int(prefill_batch), 1)
        # the shared-prefix cache resumes a prompt at a page-aligned hit,
        # which takes the chunk machinery
        self.prefix_cache = bool(prefix_cache) and self.prefill_chunk is not None
        self.alloc = PageAllocator(self.n_pages)
        self.cache = model.init_paged_cache(self.n_slots, self.n_pages, self.max_pages,
                                            device=self.device)
        self._paged = _paged_leaves(self.cache)
        self.slots: List[Optional[_Slot]] = [None] * self.n_slots
        self._page_table = np.full(
            (self.n_slots, self.max_pages), self.alloc.trash, np.int32
        )
        self._pt_sent: Optional[np.ndarray] = None  # the table last copied to the device
        # the static device inputs of a decode step, bound to every paged
        # layer: the page table, and the slots' tokens, positions and write
        # pages in one buffer (one copy to the device a step)
        ns = self.n_slots
        self._pt_dev = torch.from_numpy(self._page_table.copy()).to(self.device)
        self._step_in = self._inputs({"tok": (ns, 1), "pos": (ns,), "write_page": (ns,)})
        for leaf in self._paged:
            leaf.bind_tables(self._pt_dev, self._step_in["write_page"])
        # the static device inputs of an admission (per bucket: prefill and
        # graft) and of a chunk, each refilled with one copy a step
        self._adm_in: Dict[int, Dict[str, torch.Tensor]] = {}
        self._chunk_in: Optional[Dict[str, torch.Tensor]] = None
        self.eager = bool(eager)
        self._graphs: Dict[tuple, CapturedStep] = {}
        self.trace_counts: Dict[str, int] = {"decode": 0, "prefill": 0, "graft": 0, "chunk": 0}
        self._admit_seq = 0
        self.pending: deque = deque()
        self.finished: List[Request] = []
        self.stats: Dict[str, int] = {
            "steps": 0, "active_slot_steps": 0, "evictions": 0, "decode_tokens": 0,
            "prefill_batches": 0, "prefill_rows": 0, "chunks": 0,
            "prefix_hits": 0, "prefix_misses": 0, "prefix_pages_shared": 0,
        }
        # decode-interference samples: gaps between decode steps that shared
        # their scheduler iteration with prefill work, and pure-decode ones
        self._itl_decode_s: List[float] = []
        self._itl_with_prefill_s: List[float] = []
        # the first few admissions re-encode one prefilled page to feed the
        # KV quality metrics when the registry is on
        self._kv_probe_budget = 8

    # ------------------------------------------------------------- capacity

    @property
    def capacity_tokens(self) -> int:
        return self.max_pages * self.page

    def validate(self, req: Request) -> None:
        need = len(req.prompt) + req.max_new_tokens
        if len(req.prompt) < 1:
            raise ValueError(f"request {req.rid}: empty prompt")
        if need > self.capacity_tokens:
            raise ValueError(
                f"request {req.rid}: prompt+max_new={need} exceeds per-slot "
                f"capacity {self.capacity_tokens} (= max_pages * page)"
            )

    # --------------------------------------------------------- device steps

    def _tokens(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(rows, np.int64)).to(self.device)

    def _set_tables(self, write_page: np.ndarray) -> None:
        """Hand the allocator's tables to every paged layer: the page table
        copied into the shared device buffer (only when it changed), the
        write pages as host integers (the eager step's)."""
        if self._pt_sent is None or not np.array_equal(self._pt_sent, self._page_table):
            self._pt_sent = self._page_table.copy()
            self._pt_dev.copy_(torch.from_numpy(self._pt_sent))
        for leaf in self._paged:
            leaf.with_tables(self._pt_dev, write_page)

    def _replay(self, name: str, key: tuple, body):
        """The outputs of step ``name``'s graph for ``key`` and the active
        ``ActQuant`` and ``KVQuant``, captured on the key's first call
        (counted under ``trace_counts[name]``), which returns its eager
        first run's outputs in the graph's (a later graph reads them).  On
        the CPU ``body`` runs eagerly."""
        if self.device.type != "cuda":
            return body()
        full = (name, *key, default_act_quant(), default_kv_quant())
        graph = self._graphs.get(full)
        if graph is None:
            graph = self._graphs[full] = CapturedStep(body, self.device)
            self.trace_counts[name] += 1
            return graph.out
        return graph.replay()

    def _inputs(self, sizes: Dict[str, Tuple[int, ...]]) -> Dict[str, torch.Tensor]:
        """Views ``name -> shape`` of one flat int64 device buffer (``"all"``)."""
        flat = torch.zeros((sum(int(np.prod(v)) for v in sizes.values()),), dtype=torch.int64,
                           device=self.device)
        out, at = {"all": flat}, 0
        for name, shape in sizes.items():
            n = int(np.prod(shape))
            out[name] = flat[at : at + n].view(shape)
            at += n
        return out

    def _decode(self, tokens: np.ndarray, pos: np.ndarray, write_page: np.ndarray,
                fill: Optional[bool] = None) -> np.ndarray:
        """One decode step over the slot pool; the next tokens on the host.
        ``fill`` (default: whether a slot writes a page) picks the graph."""
        self._set_tables(write_page)
        step_in = np.concatenate([tokens.reshape(-1), pos, write_page]).astype(np.int64)
        self._step_in["all"].copy_(torch.from_numpy(step_in))
        if self.eager:
            logits, self.cache = self.model.decode_step(
                self.params, self.cache, self._step_in["tok"], self._step_in["pos"])
            return _argmax_last(logits)
        if fill is None:
            fill = bool((write_page != self.alloc.trash).any())
        return self._replay("decode", (fill,), lambda: self._decode_body(fill)).cpu().numpy()

    def _decode_body(self, fill: bool) -> torch.Tensor:
        """The step a graph captures: every input from the static buffers,
        the argmax inside."""
        logits, _ = self.model.decode_step(self.params, self.cache, self._step_in["tok"],
                                           self._step_in["pos"], fill=fill)
        return torch.argmax(logits[:, -1, :], dim=-1)

    def _prefill(self, tokens: np.ndarray, real_len: np.ndarray, slots: np.ndarray,
                 page_ids: np.ndarray):
        """Bucketed prefill of ``prefill_batch`` rows with a dense cache (the
        PVQ encode happens in the graft).  The captured step takes the
        graft's inputs too, in the same copy to the device.  Returns ``(next
        tokens on the host, prefill caches)``."""
        if self.eager:
            with kv_quant_scope(None):
                logits, pre = self.model.prefill_bucketed(
                    self.params, {"tokens": self._tokens(tokens)}, self._tokens(real_len))
            return _argmax_last(logits), pre
        lb = tokens.shape[1]
        if lb not in self._adm_in:
            b = self.prefill_batch
            self._adm_in[lb] = self._inputs({"tokens": (b, lb), "real": (b,), "slots": (b,),
                                             "page_ids": (b, lb // self.page)})
        host = np.concatenate([tokens.reshape(-1), real_len, slots, page_ids.reshape(-1)])
        self._adm_in[lb]["all"].copy_(torch.from_numpy(host.astype(np.int64)))
        tok, pre = self._replay("prefill", (lb,), lambda: self._prefill_body(lb))
        return tok.cpu().numpy(), pre

    def _prefill_body(self, lb: int):
        buf = self._adm_in[lb]
        with kv_quant_scope(None):
            logits, pre = self.model.prefill_bucketed(self.params, {"tokens": buf["tokens"]},
                                                      buf["real"])
        return torch.argmax(logits[:, -1, :], dim=-1), pre

    def _graft(self, pre, slots: np.ndarray, page_ids: np.ndarray, real_len: np.ndarray) -> None:
        """Row ``i`` of the prefill batch lands in slot ``slots[i]``.  The
        prefill caches mirror the paged cache's nesting, ``{"k", "v"}``
        dicts ``(B, L_b, n_kv, hd)`` where it holds a ``PagedKV``.  The
        captured graft reads ``pre`` (the prefill graph's outputs) and the
        indices the prefill's copy put on the device."""
        lb = page_ids.shape[1] * self.page
        if self.eager:
            rows = [(int(slots[i]), page_ids[i], int(real_len[i]))
                    for i in range(self.prefill_batch)]
        else:
            buf = self._adm_in[lb]
            rows = [(buf["slots"][i : i + 1], buf["page_ids"][i], buf["real"][i : i + 1])
                    for i in range(self.prefill_batch)]

        def walk(c, p):
            if is_paged_kv(c):
                for i, row in enumerate(rows):
                    c.graft(p["k"][i : i + 1], p["v"][i : i + 1], *row)
            elif isinstance(c, dict):
                for key, sub in c.items():
                    walk(sub, p[key])
            elif isinstance(c, list):
                for sub, p_sub in zip(c, p):
                    walk(sub, p_sub)

        if self.eager:
            walk(self.cache, pre)
        else:
            self._replay("graft", (lb,), lambda: walk(self.cache, pre))

    def _chunk(self, tokens: np.ndarray, slot: int, start: int, page_ids: np.ndarray,
               real_len: int) -> np.ndarray:
        """One chunked-prefill step: ``C`` tokens of one slot's context,
        read against its packed pages through the page table and grafted
        into ``page_ids``."""
        self._set_tables(np.full((self.n_slots,), self.alloc.trash, np.int32))
        if self.eager:
            logits, self.cache = self.model.prefill_chunk(
                self.params, self.cache, self._tokens(tokens), slot, start, page_ids, real_len
            )
            return _argmax_last(logits)
        if self._chunk_in is None:
            ctk = self.chunk_tokens
            self._chunk_in = self._inputs({"tokens": (1, ctk), "slot": (1,), "start": (1,),
                                           "real": (1,), "page_ids": (ctk // self.page,)})
        host = np.concatenate([tokens.reshape(-1), [slot, start, real_len], page_ids])
        self._chunk_in["all"].copy_(torch.from_numpy(host.astype(np.int64)))
        return self._replay("chunk", (), self._chunk_body).cpu().numpy()

    def _chunk_body(self) -> torch.Tensor:
        buf = self._chunk_in
        logits, _ = self.model.prefill_chunk(self.params, self.cache, buf["tokens"], buf["slot"],
                                             buf["start"], buf["page_ids"], buf["real"])
        return torch.argmax(logits[:, -1, :], dim=-1)

    # ------------------------------------------------------------ admission

    def _free_slot(self, exclude: Optional[set] = None) -> Optional[int]:
        for s, st in enumerate(self.slots):
            if st is None and (exclude is None or s not in exclude):
                return s
        return None

    @staticmethod
    def _ctx_tokens(req: Request) -> List[int]:
        if req.generated:
            # re-admission after eviction: the last generated token is the
            # pending decode input, everything before it is prefill context
            return list(req.prompt) + req.generated[:-1]
        return list(req.prompt)

    def _prefix_keys(self, ctx: Sequence[int]) -> List[str]:
        """Chain hash per full page of the context, from position 0: key
        ``b`` covers blocks ``0..b`` (content and absolute position)."""
        h = hashlib.blake2b(digest_size=16)
        out = []
        page = self.page
        for b in range(len(ctx) // page):
            h.update(np.asarray(ctx[b * page : (b + 1) * page], np.int64).tobytes())
            out.append(h.hexdigest())
        return out

    def _start_timing(self, req: Request, t_now: Optional[float]) -> float:
        t_adm = time.perf_counter()
        if req.submit_t is None:
            req.submit_t = t_adm if t_now is None else t_now
        base = req.evict_t if req.evict_t is not None else req.submit_t
        req.queue_wait_s += max(t_adm - base, 0.0)
        req.admit_t = t_adm
        return t_adm

    def _chunk_routed(self, ctx: List[int]) -> bool:
        """A context takes the chunked path when it is longer than one
        chunk, or when the prefix cache can hand it packed pages."""
        if self.prefill_chunk is None:
            return False
        if len(ctx) > self.chunk_tokens:
            return True
        if not self.prefix_cache or (len(ctx) - 1) // self.page < 1:
            return False
        keys = self._prefix_keys(ctx)
        return bool(keys) and self.alloc.lookup(keys[0]) is not None

    def admit_pending(self, t_now: Optional[float] = None) -> int:
        """Admit from the queue head until blocked (FIFO).  Short
        same-bucket prompts are batch-claimed up to ``prefill_batch``; long
        or prefix-hitting prompts enter the chunked state machine."""
        admitted = 0
        while self.pending:
            req = self.pending[0]
            self.validate(req)
            ctx = self._ctx_tokens(req)
            if self._chunk_routed(ctx):
                n = self._admit_chunked(req, ctx, t_now)
            else:
                n = self._admit_batch(t_now)
            if not n:
                break
            admitted += n
        return admitted

    def _admit_chunked(self, req: Request, ctx: List[int], t_now) -> int:
        """Claim a slot and all the context's full-block pages up front
        (prefill then never waits on the pool), map shared-prefix pages
        into the page table, and park the slot in phase "prefill"."""
        plen = len(ctx)
        n_full = plen // self.page
        slot = self._free_slot()
        if slot is None:
            return 0
        keys = self._prefix_keys(ctx) if self.prefix_cache else []
        # never map the block holding the LAST context token: its logits
        # must be recomputed for the first generated token
        max_hit = (plen - 1) // self.page
        hits: List[int] = []
        for key in keys[:max_hit]:
            pid = self.alloc.lookup(key)
            if pid is None or not self.alloc.share(pid):
                break
            hits.append(pid)
        ids = self.alloc.alloc_many(n_full - len(hits))
        if ids is None:
            if hits:
                self.alloc.free(hits)  # roll the shares back; try later
            return 0
        self._start_timing(req, t_now)
        req.prefix_hit_pages += len(hits)
        st = _Slot(
            req=req, length=0, pages=hits + ids, admit_order=self._admit_seq,
            phase="prefill", ctx=ctx, chunk_pos=len(hits) * self.page,
            block_keys=keys or None,
        )
        self._admit_seq += 1
        self.slots[slot] = st
        self._page_table[slot, :] = self.alloc.trash
        self._page_table[slot, :n_full] = st.pages
        self.pending.popleft()
        self.stats["prefix_hits"] += len(hits)
        self.stats["prefix_pages_shared"] += len(hits)
        if self.prefix_cache and len(hits) < max_hit:
            self.stats["prefix_misses"] += 1
        if obs.enabled():
            obs.counter("engine.admissions").inc()
            if hits:
                obs.counter("prefix_cache.hit").add(len(hits))
                obs.counter("prefix_cache.pages_shared").add(len(hits))
            if self.prefix_cache and len(hits) < max_hit:
                obs.counter("prefix_cache.miss").inc()
            obs.event("engine/admit", args={
                "rid": req.rid, "ctx": plen, "chunked": 1, "prefix_pages": len(hits),
            })
        return 1

    def _admit_batch(self, t_now) -> int:
        """Batch-claim slots and pages FIFO from the queue head: every
        consecutive request in the head's length bucket joins, up to
        ``prefill_batch`` rows, then one bucketed prefill and one graft
        admit them all.  A request that needs the chunked path, another
        bucket, or resources that ran out stops the batch."""
        page = self.page
        lb = bucket_len(len(self._ctx_tokens(self.pending[0])), page)
        rows: List[Tuple[Request, List[int], int, List[int]]] = []
        claimed: set = set()
        while self.pending and len(rows) < self.prefill_batch:
            req = self.pending[0]
            self.validate(req)
            ctx = self._ctx_tokens(req)
            if bucket_len(len(ctx), page) != lb or self._chunk_routed(ctx):
                break
            slot = self._free_slot(exclude=claimed)
            if slot is None:
                break
            ids = self.alloc.alloc_many(len(ctx) // page)
            if ids is None:
                break
            claimed.add(slot)
            rows.append((req, ctx, slot, ids))
            self.pending.popleft()
        if not rows:
            return 0
        self._run_batch_prefill(rows, lb, t_now)
        return len(rows)

    def _run_batch_prefill(self, rows, lb: int, t_now) -> None:
        """One bucketed prefill of the claimed rows, then their graft, at
        ``prefill_batch`` rows on every path: the rows past the claimed
        ones repeat row 0 (the reference's static compile shape; the
        repeated graft rewrites the same bytes to the same pages)."""
        page = self.page
        n, bsz = len(rows), self.prefill_batch
        toks = np.zeros((bsz, lb), np.int32)
        real = np.ones((bsz,), np.int32)
        slots = np.zeros((bsz,), np.int32)
        ids_arr = np.full((bsz, lb // page), self.alloc.trash, np.int32)
        for i, (req, ctx, slot, ids) in enumerate(rows):
            toks[i, : len(ctx)] = np.asarray(ctx, np.int32)
            real[i] = len(ctx)
            slots[i] = slot
            ids_arr[i, : len(ids)] = ids
            self._start_timing(req, t_now)
        for arr in (toks, real, slots, ids_arr):
            arr[n:] = arr[0]
        t0 = time.perf_counter()
        with obs.span("engine/prefill", args={"bucket": lb, "rows": n, "batch": bsz}):
            tok_host, pre = self._prefill(toks, real, slots, ids_arr)
        if obs.enabled() and self._kv_probe_budget > 0 and int(real[0]) >= page:
            self._kv_probe_budget -= 1
            self._probe_kv_quality(pre)
        with obs.span("engine/graft", args={"rows": n, "pages": int((real[:n] // page).sum())}):
            self._graft(pre, slots, ids_arr, real)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        del pre
        dt = time.perf_counter() - t0
        self.stats["prefill_batches"] += 1
        self.stats["prefill_rows"] += n
        for i, (req, ctx, slot, ids) in enumerate(rows):
            # each row experienced the whole batch call as its latency
            req.prefill_compute_s += dt
            if req.evict_t is not None:
                # the eviction's cost lands at re-admission: the re-queue
                # wait plus the teacher-forced re-prefill
                req.evict_cost_s += max(time.perf_counter() - req.evict_t, 0.0)
                req.evict_t = None
            if self.prefix_cache:
                for b, key in enumerate(self._prefix_keys(ctx)):
                    self.alloc.register(ids[b], key)
            if not req.generated:
                req.generated.append(int(tok_host[i]))
                req.first_token_t = time.perf_counter()
            if req.done:
                # prefill alone satisfied the request: it never occupies a
                # slot; registered pages park in the cached pool
                self.alloc.free(ids)
                self._finish(req)
                continue
            self.slots[slot] = _Slot(
                req=req, length=len(ctx), pages=list(ids), admit_order=self._admit_seq,
            )
            self._admit_seq += 1
            self._page_table[slot, :] = self.alloc.trash
            self._page_table[slot, : len(ids)] = ids
        if obs.enabled():
            obs.counter("engine.admissions").add(n)
            for req, ctx, _, _ in rows:
                obs.event("engine/admit", args={"rid": req.rid, "ctx": len(ctx)})

    # --------------------------------------------------- chunked prefill

    def _prefill_step(self) -> int:
        """One chunk (``C`` tokens) for the oldest slot still in phase
        "prefill": one chunk between decode steps bounds how long an active
        slot waits on admission work.  Returns the chunk's tokens (0 when no
        slot is prefilling)."""
        cand = [
            (s, st) for s, st in enumerate(self.slots)
            if st is not None and st.phase == "prefill"
        ]
        if not cand:
            return 0
        s, st = min(cand, key=lambda t: t[1].admit_order)
        req, ctx = st.req, st.ctx
        plen = len(ctx)
        n_full = plen // self.page
        ctk = self.chunk_tokens
        start = st.chunk_pos
        end = min(start + ctk, plen)
        toks = np.zeros((1, ctk), np.int32)
        toks[0, : end - start] = np.asarray(ctx[start:end], np.int32)
        page_ids = np.full((ctk // self.page,), self.alloc.trash, np.int32)
        b0 = start // self.page
        for j in range(ctk // self.page):
            if b0 + j < n_full:
                page_ids[j] = st.pages[b0 + j]
        t0 = time.perf_counter()
        with obs.span("engine/prefill_chunk", args={
            "rid": req.rid, "start": start, "end": end, "ctx": plen,
        }):
            tok0 = self._chunk(toks, s, start, page_ids, plen)
        req.prefill_compute_s += time.perf_counter() - t0
        self.stats["chunks"] += 1
        if self.prefix_cache and st.block_keys:
            for b in range(b0, min(end // self.page, n_full)):
                self.alloc.register(st.pages[b], st.block_keys[b])
        st.chunk_pos = end
        if end < plen:
            return end - start
        # final chunk: prefill -> decode
        if not req.generated:
            req.generated.append(int(tok0[0]))
            req.first_token_t = time.perf_counter()
            if req.admit_t is not None:
                req.chunk_wait_s += max(
                    req.first_token_t - req.admit_t - req.prefill_compute_s, 0.0
                )
        if req.evict_t is not None:
            req.evict_cost_s += max(time.perf_counter() - req.evict_t, 0.0)
            req.evict_t = None
        st.phase = "decode"
        st.ctx = None
        st.length = plen
        if req.done:
            self._retire(s)
        return end - start

    def _probe_kv_quality(self, pre) -> None:
        """KV quality probe: re-encode the first page of one prefilled layer
        with the engine's ``KVQuant``, so ``_kv_encode_planes`` records its
        SNR, clamp and scale metrics.  Sampled, never on the per-token path."""
        from ..core.packed import _fit_group, _kv_encode_planes

        kvq = default_kv_quant()

        def find(c):
            if isinstance(c, dict):
                if "k" in c and "v" in c:
                    return c
                subs = c.values()
            elif isinstance(c, list):
                subs = c
            else:
                return None
            for sub in subs:
                hit = find(sub)
                if hit is not None:
                    return hit
            return None

        kv = find(pre)
        if kv is None or kvq is None:
            return
        k = kv["k"].to(torch.float32)[:, : self.page]
        _kv_encode_planes(k, _fit_group(kvq.group, k.shape[-1]), kvq.k)

    # ----------------------------------------------------- retire and evict

    def _finish(self, req: Request) -> None:
        req.finish_t = time.perf_counter()
        self.finished.append(req)
        if obs.enabled():
            obs.counter("engine.requests_finished").inc()
            if req.submit_t is not None:
                obs.histogram("engine.request_latency_s").record(req.finish_t - req.submit_t)
                if req.first_token_t is not None:
                    obs.histogram("engine.ttft_s").record(req.first_token_t - req.submit_t)
            obs.histogram("engine.queue_wait_s").record(req.queue_wait_s)
            obs.histogram("engine.prefill_compute_s").record(req.prefill_compute_s)
            obs.histogram("engine.chunk_wait_s").record(req.chunk_wait_s)
            if req.evictions:
                obs.histogram("engine.evict_cost_s").record(req.evict_cost_s)
            obs.event("engine/retire", args={"rid": req.rid})

    def _release(self, s: int) -> _Slot:
        st = self.slots[s]
        if st.pages:
            self.alloc.free(st.pages)
        self._page_table[s, :] = self.alloc.trash
        self.slots[s] = None
        return st

    def _retire(self, s: int) -> None:
        self._finish(self._release(s).req)

    def _evict(self, s: int) -> None:
        st = self._release(s)
        st.req.evictions += 1
        st.req.evict_t = time.perf_counter()
        self.stats["evictions"] += 1
        if obs.enabled():
            obs.counter("engine.evictions").inc()
            obs.event("engine/evict",
                      args={"rid": st.req.rid, "kept_tokens": len(st.req.generated)})
        # queue head: the victim resumes as soon as pages free up
        self.pending.appendleft(st.req)

    # ----------------------------------------------------------- decode step

    def step(self) -> int:
        """One decode step over every active slot; returns the tokens
        generated (0 when idle).

        Slots completing a PVQ block this step get their page pre-assigned
        (``write_page``); if the pool cannot cover every completing slot,
        the youngest active sequence is evicted until it can (a lone
        sequence never needs more than ``max_pages <= n_pages``).  Slots in
        phase "prefill" neither decode nor get evicted."""
        while True:
            active = [
                (s, st) for s, st in enumerate(self.slots)
                if st is not None and st.phase == "decode"
            ]
            if not active:
                return 0
            needed = sum(1 for _, st in active if (st.length + 1) % self.page == 0)
            if needed <= self.alloc.available:
                break
            victim = max(active, key=lambda t: t[1].admit_order)[0]
            self._evict(victim)

        tokens = np.zeros((self.n_slots, 1), np.int32)
        pos = np.zeros((self.n_slots,), np.int32)
        write_page = np.full((self.n_slots,), self.alloc.trash, np.int32)
        for s, st in active:
            tokens[s, 0] = st.req.generated[-1]
            pos[s] = st.length
            if (st.length + 1) % self.page == 0:
                pid = self.alloc.alloc()
                st.pages.append(pid)
                self._page_table[s, st.length // self.page] = pid
                write_page[s] = pid

        span = obs.NOOP
        if obs.enabled():
            span = obs.span("engine/decode_step", args={
                "active": len(active), "queue": len(self.pending),
                "free_pages": self.alloc.available,
            })
        with span:
            tok_host = self._decode(tokens, pos, write_page)
        self.stats["steps"] += 1
        self.stats["active_slot_steps"] += len(active)
        self.stats["decode_tokens"] += len(active)
        if obs.enabled():
            obs.counter("engine.decode_steps").inc()
            obs.counter("engine.decode_tokens").add(len(active))
            obs.gauge("engine.queue_depth").set(len(self.pending))
            obs.gauge("engine.page_pool_free").set(self.alloc.available)
            obs.gauge("engine.active_slots").set(len(active))
            obs.trace_counter("engine.queue_depth", len(self.pending))
            obs.trace_counter("engine.page_pool_free", self.alloc.available)
            obs.trace_counter("engine.active_slots", len(active))
        for s, st in active:
            st.length += 1
            st.req.generated.append(int(tok_host[s]))
            if st.req.done:
                self._retire(s)
        return len(active)

    # --------------------------------------------------------------- warmup

    def warmup(self, prompt_lens: Sequence[int] = ()) -> None:
        """Run a prefill and graft for every prompt bucket at the engine's
        prefill batch, one chunk, and the decode step without and with a
        block fill (on a card each captures its graph), before the timed
        run, which then captures nothing unless a re-admitted context needs
        a new bucket.  The engine must be idle; the dummy writes target the
        trash page and tail rings a real graft overwrites."""
        if any(st is not None for st in self.slots):
            raise RuntimeError("warmup needs an idle engine")
        buckets = {bucket_len(max(int(p), 1), self.page) for p in prompt_lens}
        if self.prefill_chunk is not None:
            buckets = {lb for lb in buckets if lb <= self.chunk_tokens}
        bsz = self.prefill_batch
        trash = self.alloc.trash
        for lb in sorted(buckets):
            slots, real = np.zeros((bsz,), np.int32), np.ones((bsz,), np.int32)
            ids = np.full((bsz, lb // self.page), trash, np.int32)
            _, pre = self._prefill(np.zeros((bsz, lb), np.int32), real, slots, ids)
            self._graft(pre, slots, ids, real)
        if self.prefill_chunk is not None:
            ctk = self.chunk_tokens
            self._chunk(np.zeros((1, ctk), np.int32), 0, 0,
                        np.full((ctk // self.page,), trash, np.int32), 1)
        for fill in (False, True):
            self._decode(np.zeros((self.n_slots, 1), np.int32),
                         np.zeros((self.n_slots,), np.int32),
                         np.full((self.n_slots,), trash, np.int32), fill=fill)

    # ------------------------------------------------------------- run loop

    async def _feed(self, trace: List[Request], t0: float, time_scale: float):
        loop = asyncio.get_running_loop()
        for req in sorted(trace, key=lambda r: r.arrival):
            delay = (t0 + req.arrival * time_scale) - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            req.submit_t = time.perf_counter()
            self.pending.append(req)

    async def _run_async(self, trace: List[Request], time_scale: float):
        for req in trace:
            self.validate(req)
        t_start = time.perf_counter()
        loop = asyncio.get_running_loop()
        feeder = asyncio.create_task(self._feed(trace, loop.time(), time_scale))
        last_step_end: Optional[float] = None
        try:
            while True:
                pb0 = self.stats["prefill_batches"]
                self.admit_pending()
                chunked = self._prefill_step()
                n = self.step()
                if n:
                    now = time.perf_counter()
                    if last_step_end is not None:
                        # the gap between two decode steps, split by whether
                        # prefill work ran inside it
                        gap = now - last_step_end
                        if chunked or self.stats["prefill_batches"] > pb0:
                            self._itl_with_prefill_s.append(gap)
                        else:
                            self._itl_decode_s.append(gap)
                    last_step_end = now
                prefilling = any(
                    st is not None and st.phase == "prefill" for st in self.slots
                )
                if n or chunked:
                    await asyncio.sleep(0)  # yield to the arrival feeder
                elif feeder.done() and not self.pending and not prefilling:
                    break
                else:
                    last_step_end = None  # idle: gaps are not ITL samples
                    await asyncio.sleep(0.0005)  # wait for arrivals
        finally:
            await feeder
        return self.report(time.perf_counter() - t_start)

    def run(self, trace: Sequence[Request], *, time_scale: float = 1.0) -> Dict[str, Any]:
        """Serve a trace to completion; returns the metrics report.
        ``time_scale`` stretches or compresses the arrival times."""
        return asyncio.run(self._run_async(list(trace), time_scale))

    # -------------------------------------------------------------- metrics

    def report(self, wall_s: float) -> Dict[str, Any]:
        """The reference's report: ``trace_counts`` holds the captures of
        the decode, prefill, graft and chunk graphs under the reference's
        keys (0 on the CPU and with ``eager=True``)."""
        done = self.finished
        toks = sum(len(r.generated) for r in done)
        lat = [r.finish_t - r.submit_t for r in done
               if r.finish_t is not None and r.submit_t is not None]
        ttft = [r.first_token_t - r.submit_t for r in done
                if r.first_token_t is not None and r.submit_t is not None]
        lat_h = Histogram.from_values(lat)
        ttft_h = Histogram.from_values(ttft)
        qwait_h = Histogram.from_values(r.queue_wait_s for r in done)
        pcomp_h = Histogram.from_values(r.prefill_compute_s for r in done)
        cwait_h = Histogram.from_values(r.chunk_wait_s for r in done)
        evict_h = Histogram.from_values(r.evict_cost_s for r in done if r.evictions)
        itl_h = Histogram.from_values(self._itl_decode_s)
        itl_pf_h = Histogram.from_values(self._itl_with_prefill_s)

        if obs.enabled():
            # one gauge per step (report() may run again, so not a counter)
            for fn, n in self.trace_counts.items():
                obs.gauge("engine.trace_count", {"fn": fn}).set(n)
            obs.gauge("engine.itl_p99_s").set(itl_h.percentile(99))
            obs.gauge("engine.itl_with_prefill_p99_s").set(itl_pf_h.percentile(99))

        steps = max(self.stats["steps"], 1)
        return {
            "requests": len(done),
            "generated_tokens": toks,
            "wall_s": round(wall_s, 4),
            "tokens_per_s": round(toks / max(wall_s, 1e-9), 2),
            "latency_p50_s": round(lat_h.percentile(50), 4),
            "latency_p99_s": round(lat_h.percentile(99), 4),
            "ttft_p50_s": round(ttft_h.percentile(50), 4),
            "ttft_p99_s": round(ttft_h.percentile(99), 4),
            "queue_wait_p50_s": round(qwait_h.percentile(50), 4),
            "queue_wait_p99_s": round(qwait_h.percentile(99), 4),
            "prefill_compute_p50_s": round(pcomp_h.percentile(50), 4),
            "prefill_compute_p99_s": round(pcomp_h.percentile(99), 4),
            "chunk_wait_p50_s": round(cwait_h.percentile(50), 4),
            "chunk_wait_p99_s": round(cwait_h.percentile(99), 4),
            "itl_p99_s": round(itl_h.percentile(99), 6),
            "itl_with_prefill_p99_s": round(itl_pf_h.percentile(99), 6),
            "itl_samples": len(self._itl_decode_s),
            "itl_with_prefill_samples": len(self._itl_with_prefill_s),
            "prefill_batches": self.stats["prefill_batches"],
            "prefill_rows": self.stats["prefill_rows"],
            "chunks": self.stats["chunks"],
            "prefix_hits": self.stats["prefix_hits"],
            "prefix_misses": self.stats["prefix_misses"],
            "prefix_pages_shared": self.stats["prefix_pages_shared"],
            "eviction_cost_total_s": round(evict_h.total, 4),
            "eviction_cost_p50_s": round(evict_h.percentile(50), 4),
            "slot_utilization": round(
                self.stats["active_slot_steps"] / (steps * self.n_slots), 4
            ),
            "evictions": self.stats["evictions"],
            "decode_steps": self.stats["steps"],
            "n_slots": self.n_slots,
            "n_pages": self.n_pages,
            "page": self.page,
            "trace_counts": dict(self.trace_counts),
            "outputs": {r.rid: list(r.generated) for r in done},
        }
