"""Model API for the ported families (port of ``repro.nn.models``).

    model = Model(cfg)
    params = model.init(seed, device=...)
    logits, cache = model.prefill(params, {"tokens": tokens}, cache_len)
    logits, cache = model.decode_step(params, cache, token, pos)

``pos`` is a host integer: the port's lockstep decode branches on it in
Python where the reference traces ``lax.cond``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ModelConfig
from ..core.packed import is_packed_kv
from . import layers as L
from . import transformer as T
from .layers import Params


class Model:
    def __init__(self, cfg: ModelConfig):
        if not cfg.tie_embeddings or cfg.learned_positions or cfg.family != "dense":
            raise NotImplementedError(f"{cfg.name}: only tied-embedding dense models are ported")
        self.cfg = cfg
        self.plan = T.segment_plan(cfg, "decoder")

    def init(self, seed: int = 0, device="cuda") -> Params:
        """Random init from ``seed`` (a ``torch.Generator`` on ``device``);
        same shapes, names and distributions as the reference, other numbers."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.param_dtype)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        params: Params = {
            "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype=dtype, device=device)
        }
        params["segments"] = {
            f"seg{i}": T.init_segment(gen, cfg, seg, device) for i, seg in enumerate(self.plan)
        }
        params["final_norm"] = T._init_norm(cfg, dtype, device)
        return params

    def _embed_tokens(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return L.embed(params["embed"], tokens, dtype=getattr(torch, self.cfg.compute_dtype))

    def _head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return L.unembed(params["embed"], x)

    def forward(self, params: Params, batch: Dict[str, torch.Tensor], *, mode: str = "prefill"):
        """Full-sequence forward: ``(logits, caches | None)``."""
        cfg = self.cfg
        x = self._embed_tokens(params, batch["tokens"])
        caches = {}
        for i, seg in enumerate(self.plan):
            x, c = T.run_segment(cfg, seg, params["segments"][f"seg{i}"], x, mode=mode)
            if c is not None:
                caches[f"seg{i}"] = c
        x = T._norm(cfg, params["final_norm"], x)
        return self._head(params, x), (caches if mode == "prefill" else None)

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor], cache_len: int = 0):
        """Run the prompt; return (last-position logits, decode cache).  The
        sequence-indexed cache tensors are zero-padded by ``cache_len - s``
        (packed planes included; the tail ring keeps its block length)."""
        logits, caches = self.forward(params, batch, mode="prefill")
        s = batch["tokens"].shape[1]
        pad = cache_len - s if cache_len and cache_len > s else 0
        if pad:
            for seg_cache in caches.values():
                for layer in seg_cache:
                    for entry in layer.values():
                        kv = entry["kv"]
                        if is_packed_kv(kv):
                            entry["kv"] = kv.pad_seq(pad)
                        else:
                            entry["kv"] = {
                                n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                                for n, t in kv.items()
                            }
        return logits[:, -1:, :], caches

    def decode_step(self, params: Params, cache: Any, token: torch.Tensor, pos: int):
        """token: (b, 1) int64; pos: host int (next position, lockstep batch)."""
        cfg = self.cfg
        x = self._embed_tokens(params, token)
        new_cache = {}
        for i, seg in enumerate(self.plan):
            x, new_cache[f"seg{i}"] = T.decode_segment(
                cfg, seg, params["segments"][f"seg{i}"], cache[f"seg{i}"], x, int(pos)
            )
        x = T._norm(cfg, params["final_norm"], x)
        return self._head(params, x), new_cache

    def init_cache(self, batch: int, cache_len: int, device="cuda") -> Any:
        return T.init_plan_cache(self.cfg, self.plan, batch, cache_len, device)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
