"""Model API for every family of the reference: dense, MoE, VLM, enc-dec,
the Mamba/attention hybrid and RWKV (port of ``repro.nn.models``).

    model = Model(cfg)
    params = model.init(seed, device=...)
    params = model.init(seed, device=..., pack=policy)  # packed as it is built
    loss, metrics = model.loss(params, {"tokens": ..., "targets": ...}, rng)  # train
    logits, cache = model.prefill(params, {"tokens": tokens}, cache_len)
    logits, cache = model.decode_step(params, cache, token, pos)

Batch keys: ``tokens``/``targets`` (b, s) always; ``frames`` (b, s_enc, d)
for enc-dec (whisper's audio frontend is a stub: frame embeddings come in
precomputed); ``patches`` (b, p, d) for a VLM (the vision frontend is a
stub too).  A VLM's decode positions count the patch prefix: the token
after a prompt of ``s`` tokens sits at ``prefix_len + s``.

``pos`` is a host integer on the eager lockstep path (the port's decode
branches on it in Python where the reference traces ``lax.cond``), or a
``(b,)`` device tensor of per-row positions: the step a CUDA graph
captures (``launch.serve``), over any cache, and the continuous-batching
engine's step over its paged cache (``init_paged_cache``,
``prefill_bucketed``, ``prefill_chunk``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ..configs.base import ModelConfig
from ..core.packed import is_packed_kv, quantize_layer, quantize_params
from ..core.quantize import QuantPolicy
from ..parallel.sharding import constrain, pad_dim
from . import layers as L
from . import transformer as T
from .layers import Params


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.plan = T.segment_plan(cfg, "decoder")
        self.enc_plan = T.segment_plan(cfg, "encoder") if cfg.encoder_layers else None

    def init(self, seed: int = 0, device="cuda", max_seq: int = 0,
             pack: Optional[QuantPolicy] = None) -> Params:
        """Random init from ``seed`` (a ``torch.Generator`` on ``device``);
        same shapes, names and distributions as the reference, other numbers.
        Learned positions get ``max_position`` rows (else ``max_seq``, else
        4096), as the reference's.

        ``pack`` (``serve --pvq``'s policy) packs each part as soon as it
        is built: the embedding, each block of each layer, the head; the
        dense model never exists whole.  The result is
        ``quantize_params(init(...), pack)`` byte for byte: the generator
        draws the same numbers in the same order (packing draws none), and
        a layer's codes are its slice of the packed stack's."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.param_dtype)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))

        def packed(tree: Params) -> Params:
            return tree if pack is None else quantize_params(tree, pack)

        def layer_packer(at: str, repeats: int):
            if pack is None:
                return None
            return lambda name, block: quantize_layer(block, pack, prefix=f"{at}/{name}",
                                                      repeats=repeats)

        def segments(plan, prefix: str) -> Params:
            return {f"seg{i}": T.init_segment(gen, cfg, seg, device,
                                              pack=layer_packer(f"{prefix}segments/seg{i}", seg[0]))
                    for i, seg in enumerate(plan)}

        params: Params = packed({
            "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype=dtype, device=device)
        })
        if cfg.learned_positions:
            params["pos"] = L.init_positional(gen, cfg.max_position or max_seq or 4096,
                                              cfg.d_model, dtype=dtype, device=device)
        params["segments"] = segments(self.plan, "")
        params["final_norm"] = T._init_norm(cfg, dtype, device)
        if not cfg.tie_embeddings:
            params["lm_head"] = packed({"lm_head": L.init_dense(
                gen, cfg.d_model, cfg.vocab_size, dtype=dtype, device=device)})["lm_head"]
        if self.enc_plan:
            params["encoder"] = {
                "segments": segments(self.enc_plan, "encoder/"),
                "final_norm": T._init_norm(cfg, dtype, device),
            }
        return params

    def _embed_tokens(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """Token rows in the compute dtype; times sqrt(d) (rounded to that
        dtype, as the reference's) for a VLM and gemma; plus the learned
        positions ``0 ..`` where the config has them (:meth:`_at_positions`
        moves them)."""
        cfg = self.cfg
        x = L.embed(params["embed"], tokens, dtype=getattr(torch, cfg.compute_dtype))
        if cfg.family == "vlm" or cfg.name.startswith("gemma"):
            # the factor rounded to x's dtype on the host (no copy to the
            # device: the step is captured)
            x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
        if cfg.learned_positions:
            x = x + params["pos"]["pos_embedding"][: tokens.shape[1]].to(x.dtype)
        return x

    def _at_positions(self, params: Params, x: torch.Tensor, positions) -> torch.Tensor:
        """``x`` (embedded at offset 0) moved to the learned positions
        ``positions``: a host int (the position of ``x``'s first row) or a
        device tensor of positions that broadcasts against ``x``'s ``(b,
        s)``.  The offset-0 rows are taken off and the true ones added, as
        the reference's ``decode_step`` and ``prefill_chunk`` do."""
        if not self.cfg.learned_positions:
            return x
        tab = params["pos"]["pos_embedding"]
        s = x.shape[1]
        if isinstance(positions, torch.Tensor):
            pe_t = tab[positions.to(torch.int64)]
        else:
            pe_t = tab[int(positions) : int(positions) + s]
        return x - tab[:s].to(x.dtype) + pe_t.to(x.dtype)

    def _encode(self, params: Params, frames: torch.Tensor, mode: str = "prefill") -> torch.Tensor:
        """The whisper-style encoder over precomputed frame embeddings: the
        sinusoidal positions, the bidirectional blocks, the final norm
        (rematerialised in train mode)."""
        cfg = self.cfg
        x = frames.to(getattr(torch, cfg.compute_dtype))
        x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
        for i, seg in enumerate(self.enc_plan):
            x, _, _ = T.run_segment(cfg, seg, params["encoder"]["segments"][f"seg{i}"], x,
                                    mode="train", remat=(mode == "train"))
        return T._norm(cfg, params["encoder"]["final_norm"], x)

    def _head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Logits in f32: the tied unembed, or the untied ``lm_head`` dense
        layer run on the f32 stream; vocab on the model axis."""
        if self.cfg.tie_embeddings:
            logits = L.unembed(params["embed"], x)
        else:
            logits = L.dense(params["lm_head"], x.to(torch.float32))
        return constrain(logits, "dp", None, "tp")

    def forward(self, params: Params, batch: Dict[str, torch.Tensor], *, mode: str = "train",
                rng: Optional[torch.Generator] = None):
        """Full-sequence forward: ``(logits, aux_loss, caches | None)``.

        ``mode`` is 'train' or 'prefill'.  In train mode ``aux_loss`` is the
        MoE layers' summed Switch loss (an f32 scalar) and ``rng``, a
        ``torch.Generator`` on the params' device, turns on the router
        jitter; omit it for a deterministic forward.  In prefill mode
        ``aux_loss`` is None and the caches come back."""
        cfg = self.cfg
        x = self._embed_tokens(params, batch["tokens"].to(torch.int64))
        prefix_len, enc_out = 0, None
        if cfg.family == "vlm":
            patches = batch["patches"].to(x.dtype)
            x = torch.cat([patches, x], dim=1)
            prefix_len = patches.shape[1]
        if self.enc_plan:
            enc_out = self._encode(params, batch["frames"], mode)
        x = constrain(x, "dp", "sp", None)
        aux = torch.zeros((), dtype=torch.float32, device=x.device) if mode == "train" else None
        caches = {}
        for i, seg in enumerate(self.plan):
            x, aux_i, c = T.run_segment(cfg, seg, params["segments"][f"seg{i}"], x, mode=mode,
                                        enc_out=enc_out, prefix_len=prefix_len,
                                        remat=(mode == "train"), rng=T.fold_in(rng, i))
            if aux is not None:
                aux = aux + aux_i
            if c is not None:
                caches[f"seg{i}"] = c
        x = T._norm(cfg, params["final_norm"], x)
        if prefix_len:
            x = x[:, prefix_len:, :]
        return self._head(params, x), aux, (caches if mode == "prefill" else None)

    def loss(self, params: Params, batch: Dict[str, torch.Tensor],
             rng: Optional[torch.Generator] = None):
        """``(total, {"ce", "aux", "accuracy"})``: the mean cross-entropy
        (through logsumexp) plus ``moe_aux_coef`` times the aux loss and,
        when ``z_loss_coef`` is set, the z-loss on the log-partition."""
        cfg = self.cfg
        logits, aux, _ = self.forward(params, batch, mode="train", rng=rng)
        targets = batch["targets"].to(device=logits.device, dtype=torch.int64)
        logz = _logsumexp_last(logits)
        tgt_logit = _target_logit(logits, targets)
        ce = torch.mean(logz - tgt_logit)
        total = ce + cfg.moe_aux_coef * aux
        if cfg.z_loss_coef:
            total = total + cfg.z_loss_coef * torch.mean(logz * logz)
        acc = torch.mean((_argmax_last(logits) == targets).to(torch.float32))
        return total, {"ce": ce, "aux": aux, "accuracy": acc}

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor], cache_len: int = 0):
        """Run the prompt; return (last-position logits, decode cache).  The
        sequence-indexed cache tensors are zero-padded to ``cache_len``
        rows: the MLA latents and a dense cache by ``cache_len - s``, the
        packed planes (the prompt's rows rounded up to a block) to
        ``cache_len`` rounded up to a block.  The reference pads the planes
        by ``cache_len - s``, which can leave up to a block more rows that
        no step writes or reads.  So a cache's shapes follow from its batch
        and ``cache_len``, and one captured step serves every prompt length
        of a bucket.  The tail ring keeps its block length.  A VLM's cache
        also holds its patch prefix: ``prefix_len`` rows more.  A cross
        block's encoder KV is never padded (zero keys would join its
        softmax), nor is a recurrent mixer's state (``mamba``, ``rwkv_*``:
        not sequence-indexed; Mamba's 3-D ``conv`` window is a state too)."""
        logits, _, caches = self.forward(params, batch, mode="prefill")
        s = batch["tokens"].shape[1]
        pad = cache_len - s if cache_len and cache_len > s else 0
        if pad:
            if self.cfg.family == "vlm":
                cache_len += batch["patches"].shape[1]
            for seg_cache in caches.values():
                for layer in seg_cache:
                    for entry in layer.values():
                        if "mla" in entry:  # (b, s, X) latents
                            entry["mla"] = {n: pad_dim(t, 1, pad)
                                            for n, t in entry["mla"].items()}
                        if "kv" not in entry:
                            continue
                        kv = entry["kv"]
                        if is_packed_kv(kv):
                            rows = -(-cache_len // kv.block) * kv.block
                            entry["kv"] = kv.pad_seq(rows - kv.max_len)
                        else:
                            entry["kv"] = {n: pad_dim(t, 1, pad) for n, t in kv.items()}
        return logits[:, -1:, :], caches

    def decode_step(self, params: Params, cache: Any, token: torch.Tensor, pos,
                    fill: Optional[bool] = None):
        """token: (b, 1) int64; pos: a host int (the next position of a
        lockstep batch, the eager step) or a ``(b,)`` device tensor of
        per-row positions (per-row RoPE, appends and length masks, no
        position read on the host: the step a CUDA graph captures, and the
        engine's slot pool).  With a device ``pos`` over a packed cache,
        ``fill`` is the host's block-fill choice: for ``PackedKV`` whether
        this step completes a block (required), for ``PagedKV`` None (the
        eager engine step: the host's ``write_page``), False or True (see
        ``PagedKV.append``).  Both forms of ``pos`` give the same logits.  A
        VLM's ``pos`` counts its patch prefix (the module docstring)."""
        cfg = self.cfg
        if not isinstance(pos, torch.Tensor) or pos.ndim == 0:
            pos = int(pos)
        x = self._embed_tokens(params, token)
        x = self._at_positions(params, x, pos.reshape(-1, 1) if isinstance(pos, torch.Tensor)
                               else pos)
        new_cache = {}
        for i, seg in enumerate(self.plan):
            x, new_cache[f"seg{i}"] = T.decode_segment(
                cfg, seg, params["segments"][f"seg{i}"], cache[f"seg{i}"], x, pos, fill
            )
        x = T._norm(cfg, params["final_norm"], x)
        return self._head(params, x), new_cache

    def init_cache(self, batch: int, cache_len: int, device="cuda", enc_len: int = 0) -> Any:
        """Zero decode cache; a cross block's encoder KV covers ``enc_len``
        positions (default ``cache_len``)."""
        return T.init_plan_cache(self.cfg, self.plan, batch, cache_len, device,
                                 enc_len=enc_len or cache_len)

    def init_paged_cache(self, n_slots: int, n_pages: int, max_pages: int, device="cuda") -> Any:
        """Slot-pool decode cache of the continuous-batching engine: every
        attention layer's cache is a ``PagedKV`` page pool (needs an active
        ``KVQuant``: pages are PVQ blocks)."""
        return T.init_plan_cache(self.cfg, self.plan, n_slots, max_pages, device,
                                 paged=(n_pages, max_pages))

    def prefill_bucketed(self, params: Params, batch: Dict[str, torch.Tensor],
                         real_len: torch.Tensor):
        """The engine's prefill: prompts padded to a page-aligned bucket
        length, logits read at each row's last real position ``real_len - 1``
        (causal attention keeps the padding out of every earlier position).
        Returns ``(logits (b, 1, vocab), caches)``; the caches cover the
        bucket, and rows at and after ``real_len`` are garbage behind the
        engine's length masks."""
        logits, _, caches = self.forward(params, batch, mode="prefill")
        idx = (real_len.to(torch.int64) - 1).reshape(-1, 1, 1).expand(-1, 1, logits.shape[-1])
        return torch.gather(logits, 1, idx), caches

    def prefill_chunk(self, params: Params, cache: Any, tokens: torch.Tensor, slot, start,
                      page_ids, real_len):
        """One chunked-prefill step over the paged slot pool: ``tokens (1, C)``
        (``C`` a page multiple, ``start`` page-aligned) at absolute positions
        ``start .. start + C - 1`` for slot ``slot``, attending to the slot's
        packed context ``[0, start)`` through its page table and grafting
        the chunk's blocks into ``page_ids``.  Returns ``(logits (1, 1,
        vocab), cache)``, read at ``real_len - 1 - start`` clamped into the
        chunk: meaningful on a context's final chunk only.  The indices are
        host integers (the eager engine) or device tensors (the captured
        chunk: the row is clamped and gathered on the device)."""
        cfg = self.cfg
        x = self._embed_tokens(params, tokens)
        if isinstance(start, torch.Tensor):
            x = self._at_positions(params, x, start.reshape(1, 1).to(torch.int64)
                                   + torch.arange(tokens.shape[1], device=x.device)[None])
        else:
            x = self._at_positions(params, x, start)
        new_cache = {}
        for i, seg in enumerate(self.plan):
            x, new_cache[f"seg{i}"] = T.chunk_segment(
                cfg, seg, params["segments"][f"seg{i}"], cache[f"seg{i}"], x,
                slot, start, page_ids, real_len,
            )
        x = T._norm(cfg, params["final_norm"], x)
        logits = self._head(params, x)
        if isinstance(real_len, torch.Tensor):
            idx = (real_len.reshape(1).to(torch.int64) - 1 - start).clamp(0, tokens.shape[1] - 1)
            return logits.index_select(1, idx), new_cache
        idx = min(max(int(real_len) - 1 - int(start), 0), tokens.shape[1] - 1)
        return logits[:, idx : idx + 1], new_cache


def _last_dim_sharded(x: torch.Tensor) -> bool:
    """Whether ``x`` is a DTensor whose last dim (the vocab) is sharded: the
    loss's reductions over it are then written as sharded reductions; on
    any other tensor they are the plain ops."""
    from torch.distributed.tensor import DTensor, Shard

    return isinstance(x, DTensor) and any(
        isinstance(p, Shard) and p.dim in (x.ndim - 1, -1) for p in x.placements)


def _logsumexp_last(x: torch.Tensor) -> torch.Tensor:
    """``logsumexp(x, -1)``; over a sharded vocab written out as a max and a
    sum of exponentials, two reductions that stay local to each vocab shard
    and then reduce across them (DTensor gathers the whole vocab for
    ``logsumexp``)."""
    if not _last_dim_sharded(x):
        return torch.logsumexp(x, dim=-1)
    m = x.amax(dim=-1, keepdim=True).detach()
    return (m + torch.log(torch.exp(x - m).sum(dim=-1, keepdim=True)))[..., 0]


def _target_logit(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``logits[..., targets]``.  Over a sharded vocab it is a masked sum
    over the vocab, which stays local to each shard and whose backward is
    elementwise (a gather's backward would build the gradient at the full
    batch's size on every rank); one term is the logit, the rest exact
    zeros, so the value is the gather's."""
    if not _last_dim_sharded(logits):
        return torch.gather(logits, -1, targets[..., None])[..., 0]
    hit = targets[..., None] == torch.arange(logits.shape[-1], device=logits.device)
    hit = hit.redistribute(logits.device_mesh, logits.placements)  # a local slice
    return torch.where(hit, logits, 0.0).sum(dim=-1)


def _argmax_last(x: torch.Tensor) -> torch.Tensor:
    """``argmax(x, -1)`` (the first of tied maxima).  Over a sharded last
    dim it is written as two max-reductions, which reduce across the shards
    with no read of the shard offsets on the host (a shape-only dry-run
    has no values to read)."""
    if not _last_dim_sharded(x):
        return torch.argmax(x, dim=-1)
    n = x.shape[-1]
    rev = torch.arange(n - 1, -1, -1, device=x.device)
    hit = torch.where(x == x.amax(dim=-1, keepdim=True), rev, -1)
    return (n - 1) - hit.amax(dim=-1)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
