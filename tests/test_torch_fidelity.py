"""The serve gate's metric in the reference and in the port, side by side.

``serve --agreement-min`` scores the served leg (packed weights, int8
activations, PVQ-packed KV cache) against the f32 leg (same packed weights,
f32 activations, dense cache) by teacher-forced top-1 agreement.  Here both
packages compute both legs on identical parameters (the reference's, packed
by the reference and converted through numpy) and identical tokens (the
reference's greedy output).

As a test (CPU, the reduced model in the full-width config's bf16): the
port's f32 leg matches the reference's, and its gate decision is the
reference's.

As a script, at full width with only the depth cut:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_fidelity.py \\
        --layers 4 --seed 0
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_fidelity.py \\
        --arch deepseek-v2-lite-16b --layers 2 --seed 0

it prints one JSON object: each package's served-vs-f32 agreement (strict
and with the sub-noise ties excused), the relative L2 distance between the
legs, and how far the two packages' legs are from each other.  For an MoE
model it also counts the top-k routing decisions of the teacher-forced
legs: how many differ between the served and the f32 leg in each package,
and how many differ between the packages on each leg.  An MLA model runs
without a packed KV cache (its latent cache is dense by design), as its
serve command does.  ``--pack port`` encodes the parameters with the
port's encoder (pulse-identical to the reference's, ``test_torch_packed.py``
and ``test_torch_moe.py``) and hands the same codes to the reference: its
interpret-mode encoder does not finish a full-width MoE layer in the time
a CPU run can take.  ``--whole-tiles`` runs the reference's matmul kernels
with one tile per matrix, for the same reason.
"""

from __future__ import annotations

import argparse
import dataclasses
import faulthandler
import json
import os
import signal
import sys
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import packed as ref_packed
from repro.core import quantize as ref_q
from repro.launch import serve as ref_serve
from repro.nn.models import Model as RefModel
from repro_torch.configs import get_config
from repro_torch.convert import from_reference_params
from repro_torch.core import packed as port_packed
from repro_torch.core import quantize as port_q
from repro_torch.launch import serve as port_serve
from repro_torch.nn.models import Model


def _to_numpy_tree(tree):
    if isinstance(tree, ref_packed.PackedPVQ):
        return {
            "pulses": np.asarray(tree.pulses), "scales": np.asarray(tree.scales),
            "group": tree.group, "k": tree.k, "shape": tree.shape, "dtype": tree.dtype,
            "layout": tree.layout, "scale_mode": tree.scale_mode,
        }
    if isinstance(tree, dict):
        return {k: _to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


class _Routing:
    """Records the top-k expert indices of every routing call of one
    package while ``on`` (a wrapper of its ``nn.moe._topk_argmax``; the
    reference's reports through a host callback, so it records under jit)."""

    def __init__(self, moe, *, jax_callback):
        self.moe, self.inner, self.on, self.calls = moe, moe._topk_argmax, None, {}

        def keep(idx):
            if self.on is not None:
                self.calls.setdefault(self.on, []).append(np.array(idx).reshape(-1))

        def recorded(probs, k):
            vals, idx = self.inner(probs, k)
            if jax_callback:
                jax.debug.callback(keep, idx, ordered=True)
            else:
                keep(idx)
            return vals, idx

        moe._topk_argmax = recorded

    def close(self):
        self.moe._topk_argmax = self.inner

    def decisions(self, leg):
        return np.concatenate(self.calls.get(leg, [np.zeros(0, np.int64)]))


def _ref_tree_from_port(ref_float, port_tree):
    """``ref_float`` with every leaf that the port packed replaced by the
    same code as a reference ``PackedPVQ``."""
    out = {}
    for key, sub in ref_float.items():
        got = port_tree[key]
        if isinstance(sub, dict):
            out[key] = _ref_tree_from_port(sub, got)
        elif port_packed.is_packed(got):
            out[key] = ref_packed.PackedPVQ(
                pulses=jax.numpy.asarray(got.pulses.numpy()),
                scales=jax.numpy.asarray(got.scales.numpy()), group=got.group, k=got.k,
                shape=tuple(got.shape), dtype=got.dtype, layout=got.layout,
                scale_mode=got.scale_mode,
            )
        else:
            out[key] = sub
    return out


def _phase(name, t0):
    print(json.dumps({"phase": name, "seconds": round(time.time() - t0, 1)}),
          file=sys.stderr, flush=True)


def _kv_scope(mod, kv_block, kv_group):
    return mod.kv_quant_scope(mod.KVQuant(kv_block, kv_group) if kv_block else None)


def both_packages_legs(ref_cfg, port_cfg, *, seed, batch, prompt, gen, kv_block, kv_group,
                       routing=None, pack="reference"):
    """Teacher-forced logits of both legs in both packages, on the
    reference's packed parameters and its served leg's greedy tokens:
    ``{"ref_q", "ref_f", "port_q", "port_f"}`` as f32 CPU tensors.
    ``kv_block=None`` keeps the served leg's cache dense.  ``routing``, a
    dict, receives each leg's routing decisions under the same keys.
    ``pack="port"`` encodes with the port's encoder and gives the reference
    the same codes."""
    t0 = time.time()
    ref_model = RefModel(ref_cfg)

    def policy(mod, cfg):
        return mod.QuantPolicy(
            rules=(("embedding", cfg.pvq.n_over_k_embed, cfg.pvq.group),
                   ("kernel|experts", 1.0, cfg.pvq.group)),
            scale_mode="ls",
        )

    ref_float = ref_model.init(jax.random.PRNGKey(seed))
    port_params = None
    if pack == "port":
        port_params = port_packed.quantize_params(
            from_reference_params(_to_numpy_tree(ref_float)), policy(port_q, port_cfg))
        ref_params = _ref_tree_from_port(ref_float, port_params)
    else:
        ref_params = ref_packed.quantize_params(ref_float, policy(ref_q, ref_cfg))
    del ref_float
    _phase("pack", t0)
    tokens = jax.random.randint(jax.random.PRNGKey(seed + 1), (batch, prompt), 0, ref_cfg.vocab_size)
    recorders = {}
    if routing is not None:
        from repro.nn import moe as ref_moe
        from repro_torch.nn import moe as port_moe

        recorders = {"ref": _Routing(ref_moe, jax_callback=True),
                     "port": _Routing(port_moe, jax_callback=False)}

    def leg(pkg, key, fn):
        if pkg in recorders:
            recorders[pkg].on = key
        try:
            out[key] = fn()
            if pkg == "ref":
                jax.effects_barrier()
        finally:
            if pkg in recorders:
                recorders[pkg].on = None

    out = {}
    try:
        with ref_q.act_quant_scope(ref_q.ActQuant()), _kv_scope(ref_q, kv_block, kv_group):
            seq = ref_serve.generate(ref_model, ref_params, tokens, gen=gen, cache_len=prompt + gen)
            _phase("reference generate", t0)
            leg("ref", "ref_q", lambda: ref_serve.teacher_forced_logits(
                ref_model, ref_params, seq, prompt_len=prompt))
            _phase("reference served leg", t0)
        # the reference keeps one jitted decode step per model, traced under
        # the ActQuant of its first call: drop it so the f32 leg is f32
        ref_serve._STEP_JITS.pop(ref_model, None)
        with ref_q.act_quant_scope(None), ref_q.kv_quant_scope(None):
            leg("ref", "ref_f", lambda: ref_serve.teacher_forced_logits(
                ref_model, ref_params, seq, prompt_len=prompt))
        _phase("reference f32 leg", t0)
        out = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}

        port_model = Model(port_cfg)
        if port_params is None:
            port_params = from_reference_params(_to_numpy_tree(ref_params))
        del ref_params
        port_seq = torch.from_numpy(np.asarray(seq, np.int64))
        with port_q.act_quant_scope(port_q.ActQuant()), _kv_scope(port_q, kv_block, kv_group):
            leg("port", "port_q", lambda: port_serve.teacher_forced_logits(
                port_model, port_params, port_seq, prompt_len=prompt))
        with port_q.act_quant_scope(None), port_q.kv_quant_scope(None):
            leg("port", "port_f", lambda: port_serve.teacher_forced_logits(
                port_model, port_params, port_seq, prompt_len=prompt))
        _phase("port legs", t0)
    finally:
        for rec in recorders.values():
            rec.close()
    if routing is not None:
        for pkg, rec in recorders.items():
            for key in (f"{pkg}_q", f"{pkg}_f"):
                routing[key] = rec.decisions(key)
    return out


def routing_flips(routing) -> dict:
    """Routing decisions that differ between two legs (same calls, same
    order: the legs are teacher-forced on the same tokens)."""

    def differ(a, b):
        assert a.shape == b.shape, (a.shape, b.shape)
        return int((a != b).sum())

    return {
        "routing_decisions": int(routing["port_f"].size),
        "ref_routing_served_vs_f32": differ(routing["ref_q"], routing["ref_f"]),
        "port_routing_served_vs_f32": differ(routing["port_q"], routing["port_f"]),
        "routing_f32_leg_port_vs_ref": differ(routing["ref_f"], routing["port_f"]),
        "routing_served_leg_port_vs_ref": differ(routing["ref_q"], routing["port_q"]),
    }


def compare(legs) -> dict:
    def rel(a, b):
        return float((a - b).norm() / a.norm())

    return {
        "ref_served_vs_f32": port_serve.top1_agreement(legs["ref_f"], legs["ref_q"]),
        "port_served_vs_f32": port_serve.top1_agreement(legs["port_f"], legs["port_q"]),
        "ref_rel_l2_served_vs_f32": rel(legs["ref_f"], legs["ref_q"]),
        "port_rel_l2_served_vs_f32": rel(legs["port_f"], legs["port_q"]),
        "f32_leg_port_vs_ref_rel_l2": rel(legs["ref_f"], legs["port_f"]),
        "served_leg_port_vs_ref_rel_l2": rel(legs["ref_q"], legs["port_q"]),
        "f32_leg_port_vs_ref": port_serve.top1_agreement(legs["ref_f"], legs["port_f"]),
        "served_leg_port_vs_ref": port_serve.top1_agreement(legs["ref_q"], legs["port_q"]),
    }


def _bf16(cfg):
    return dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16")


@pytest.fixture(autouse=True)
def _isolated_tune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PVQ_TUNE_CACHE", str(tmp_path / "tune.json"))
    # and the port's, whose delta_max and choices would follow it
    monkeypatch.setenv("REPRO_TORCH_PVQ_TUNE_CACHE", str(tmp_path / "torch_tune.json"))


def test_bf16_legs_and_gate_match_reference():
    """The reduced model computing in bf16, as the full-width config does
    (the other model tests run the reduced config's f32).  Tolerance for the
    f32 leg: 1e-2 relative L2, for bf16 rounding of the residual stream
    (one ulp is 2^-8 relative) in two backends; the gate's decision and
    every argmax of the f32 leg must be the reference's."""
    legs = both_packages_legs(
        _bf16(ref_get_config("smollm-360m").reduced()), _bf16(get_config("smollm-360m").reduced()),
        seed=0, batch=2, prompt=20, gen=6, kv_block=8, kv_group=16,
    )
    got = compare(legs)
    assert legs["port_q"].shape == legs["ref_q"].shape == (2, 6, 128)
    assert got["f32_leg_port_vs_ref_rel_l2"] < 1e-2, got
    assert got["f32_leg_port_vs_ref"]["top1_agreement_strict"] == 1.0, got
    ref_pass = got["ref_served_vs_f32"]["top1_agreement"] >= 0.99
    port_pass = got["port_served_vs_f32"]["top1_agreement"] >= 0.99
    assert ref_pass and port_pass, got


def _whole_tiles():
    """Give the reference's matmul kernels one tile per matrix.  Interpret
    mode costs time per grid step in proportion to the operands' size: with
    its heuristic tiles one (4, 2048) x (2048, 102400) ``lm_head`` call took
    ~350 s on the CPU, ~0.8 s as one tile.  Tiles change only the order of
    the f32 sums over groups."""
    from repro.kernels import autotune

    def whole(m, k, n, *, group=128, dtype=None, search=None, interpret=None):
        return autotune.normalize_tiles(m, k, n, group, bm=-(-m // 8) * 8, bn=n, bk=k)

    autotune.get_tiles = whole


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--layers", type=int, default=4, help="depth; every width stays full")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config in bf16 (a quick check of the script)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--kv-block", type=int, default=32)
    ap.add_argument("--kv-group", type=int, default=32)
    ap.add_argument("--pack", choices=("reference", "port"), default="reference",
                    help="whose encoder packs the parameters both packages run")
    ap.add_argument("--whole-tiles", action="store_true",
                    help="one tile per matrix for the reference's matmul kernels")
    args = ap.parse_args(argv)
    if args.whole_tiles:
        _whole_tiles()
    faulthandler.register(signal.SIGUSR1)  # `kill -USR1 <pid>` prints where a long run is
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    t0 = time.time()
    ref_cfg, port_cfg = ref_get_config(args.arch), get_config(args.arch)
    if args.reduced:
        ref_cfg, port_cfg = _bf16(ref_cfg.reduced()), _bf16(port_cfg.reduced())
    ref_cfg = dataclasses.replace(ref_cfg, n_layers=args.layers)
    port_cfg = dataclasses.replace(port_cfg, n_layers=args.layers)
    dense_cache = port_cfg.mla is not None
    routing = {} if port_cfg.moe is not None else None
    legs = both_packages_legs(
        ref_cfg, port_cfg, seed=args.seed, batch=args.batch, prompt=args.prompt_len,
        gen=args.gen, kv_block=None if dense_cache else args.kv_block,
        kv_group=None if dense_cache else args.kv_group, routing=routing, pack=args.pack,
    )
    report = {"arch": args.arch, "reduced": args.reduced, "layers": args.layers,
              "seed": args.seed, "batch": args.batch, "prompt_len": args.prompt_len,
              "gen": args.gen, "kv_pvq": not dense_cache, "pack": args.pack,
              "whole_tiles": args.whole_tiles,
              **({} if dense_cache else {"kv_block": args.kv_block, "kv_group": args.kv_group}),
              **compare(legs), **(routing_flips(routing) if routing is not None else {}),
              "seconds": round(time.time() - t0, 1)}
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
