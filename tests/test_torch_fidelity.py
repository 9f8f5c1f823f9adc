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

it prints one JSON object: each package's served-vs-f32 agreement (strict
and with the sub-noise ties excused), the relative L2 distance between the
legs, and how far the two packages' legs are from each other.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
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


def both_packages_legs(ref_cfg, port_cfg, *, seed, batch, prompt, gen, kv_block, kv_group):
    """Teacher-forced logits of both legs in both packages, on the
    reference's packed parameters and its served leg's greedy tokens:
    ``{"ref_q", "ref_f", "port_q", "port_f"}`` as f32 CPU tensors."""
    ref_model = RefModel(ref_cfg)
    policy = ref_q.QuantPolicy(
        rules=(("embedding", ref_cfg.pvq.n_over_k_embed, ref_cfg.pvq.group),
               ("kernel|experts", 1.0, ref_cfg.pvq.group)),
        scale_mode="ls",
    )
    ref_params = ref_packed.quantize_params(ref_model.init(jax.random.PRNGKey(seed)), policy)
    tokens = jax.random.randint(jax.random.PRNGKey(seed + 1), (batch, prompt), 0, ref_cfg.vocab_size)
    out = {}
    with ref_q.act_quant_scope(ref_q.ActQuant()), \
            ref_q.kv_quant_scope(ref_q.KVQuant(kv_block, kv_group)):
        seq = ref_serve.generate(ref_model, ref_params, tokens, gen=gen, cache_len=prompt + gen)
        out["ref_q"] = ref_serve.teacher_forced_logits(ref_model, ref_params, seq, prompt_len=prompt)
    with ref_q.act_quant_scope(None), ref_q.kv_quant_scope(None):
        out["ref_f"] = ref_serve.teacher_forced_logits(ref_model, ref_params, seq, prompt_len=prompt)
    out = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}

    port_model = Model(port_cfg)
    port_params = from_reference_params(_to_numpy_tree(ref_params))
    port_seq = torch.from_numpy(np.asarray(seq, np.int64))
    with port_q.act_quant_scope(port_q.ActQuant()), \
            port_q.kv_quant_scope(port_q.KVQuant(kv_block, kv_group)):
        out["port_q"] = port_serve.teacher_forced_logits(port_model, port_params, port_seq,
                                                         prompt_len=prompt)
    with port_q.act_quant_scope(None), port_q.kv_quant_scope(None):
        out["port_f"] = port_serve.teacher_forced_logits(port_model, port_params, port_seq,
                                                         prompt_len=prompt)
    return out


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=4, help="depth; every width stays full")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--kv-block", type=int, default=32)
    ap.add_argument("--kv-group", type=int, default=32)
    args = ap.parse_args(argv)
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    t0 = time.time()
    legs = both_packages_legs(
        dataclasses.replace(ref_get_config("smollm-360m"), n_layers=args.layers),
        dataclasses.replace(get_config("smollm-360m"), n_layers=args.layers),
        seed=args.seed, batch=args.batch, prompt=args.prompt_len, gen=args.gen,
        kv_block=args.kv_block, kv_group=args.kv_group,
    )
    report = {"arch": "smollm-360m", "layers": args.layers, "seed": args.seed,
              "batch": args.batch, "prompt_len": args.prompt_len, "gen": args.gen,
              "kv_block": args.kv_block, "kv_group": args.kv_group, **compare(legs),
              "seconds": round(time.time() - t0, 1)}
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
