"""End-to-end training entry point (PyTorch port of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch smollm-360m --reduced --device cpu \\
        --steps 30 --batch 8 --seq 32 --pvq-qat --pvq-k 128 --ckpt-dir /tmp/run0
    python -m repro_torch.launch.train --arch smollm-360m --steps 8 --batch 8 \\
        --seq 64 --pvq-qat --pvq-k 256 --ckpt-dir /tmp/run1 --ckpt-every 0

Wires together: config -> model -> AdamW -> step -> deterministic data
pipeline -> asynchronous checkpoints -> fault-tolerant runner, and prints
the reference's report keys as one JSON line.  ``--pvq-qat`` trains with
the paper's mixed optimization: every step projects each matmul weight and
the embedding onto the pyramid through the straight-through estimator
(``core.qat.pvq_ste`` at group 256, the encode kernel on the card), with
``--pvq-k`` pulses a group.  It runs on the CUDA card unless ``--device
cpu`` is given.

The step is eager autograd on the reference's step function (the
reference compiles it with ``jax.jit``).  The reference's ``--pvq-qat``
without ``--pvq-k`` fails inside the encoder (its K expression is None);
here argparse refuses it.  So does it refuse an enc-dec or VLM
``--arch`` (whisper-small, paligemma-3b): the loader makes no frames or
patches, and the reference's train fails on both in its forward.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Any, Optional

import torch

from ..checkpoint import Checkpointer
from ..configs import get_config
from ..core.packed import tree_map_with_path
from ..data import TokenLoader, TokenTask
from ..nn.models import build_model
from ..nn.transformer import fold_in
from ..optim import AdamW, cosine_schedule
from ..optim.adamw import tree_leaves, tree_map
from ..runtime.fault_tolerance import StragglerPolicy, TrainingRunner

#: the reference's rule for the leaves ``--pvq-qat`` projects
QAT_MIN_SIZE = 1024


def qat_projector(pvq_k: int, pvq_group: int = 256):
    """params -> params with every leaf of rank >= 2 that ``QuantPolicy()``
    matches and that holds at least ``QAT_MIN_SIZE`` elements projected
    through ``pvq_ste(leaf, pvq_k, pvq_group)`` (the whole stacked leaf,
    flattened into groups, as the reference does)."""
    from ..core.qat import pvq_ste
    from ..core.quantize import QuantPolicy

    policy = QuantPolicy()

    def visit(path, leaf):
        if leaf.ndim >= 2 and policy.match(path) and leaf.numel() >= QAT_MIN_SIZE:
            return pvq_ste(leaf, pvq_k, pvq_group)
        return leaf

    return lambda p: tree_map_with_path(visit, p)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's generator for the stochastic train features (the MoE
    router jitter): seeded by the run and advanced by the optimizer step
    counter, as the reference folds ``opt_state.step`` into its key."""
    base = torch.Generator(device=device)
    base.manual_seed(int(seed))
    return fold_in(base, int(step))


def loss_and_grads(model, params, batch, rng, project=lambda p: p):
    """``(loss, metrics, grads)``: ``model.loss`` of ``project(params)`` and
    its gradients with respect to ``params`` (a tree like ``params``; zeros
    where a leaf does not reach the loss), the params themselves untouched."""
    latent = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(latent)
    with torch.enable_grad():
        loss, metrics = model.loss(project(latent), batch, rng)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_map(lambda _: next(it), params)


def make_state_and_step(model, optimizer, *, pvq_qat=False, pvq_k=None, pvq_group=256, seed=0,
                        device="cuda", state: Optional[Any] = None):
    """Returns ``(state=(params, opt_state), step_fn(state, batch))``.

    ``state`` starts the run from given ``(params, opt_state)`` (e.g. the
    reference's, carried across by ``convert``) instead of ``model.init``.
    ``step_fn`` returns the new state and the metrics ``ce``, ``aux``,
    ``accuracy``, ``loss`` and ``grad_norm`` as device scalars."""
    if pvq_qat and pvq_k is None:
        raise ValueError("pvq_qat needs pvq_k, the pulses a group of the STE projection")
    if state is None:
        params = model.init(seed, device=device)
        state = (params, optimizer.init(params))
    project = qat_projector(pvq_k, pvq_group) if pvq_qat else (lambda p: p)

    def step_fn(state, batch):
        params, opt_state = state
        rng = step_generator(seed, opt_state.step, tree_leaves(params)[0].device)
        loss, metrics, grads = loss_and_grads(model, params, batch, rng, project)
        params, opt_state, gnorm = optimizer.update(grads, opt_state, params)
        return (params, opt_state), dict(metrics, loss=loss, grad_norm=gnorm)

    return state, step_fn


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (a run resumes from its latest step); default "
                    "<tmp>/repro_torch_train/<config name>, so runs of other configs do not "
                    "resume from each other's checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--pvq-qat", action="store_true")
    ap.add_argument("--pvq-k", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels) or cpu (their plain versions)")
    return ap


def run(argv=None, *, return_state: bool = False, failure_injector=None):
    """Parse ``argv``, train, and return ``(report, exit_code)`` (plus, with
    ``return_state``, a dict holding the model, the runner and the
    checkpointer).  ``failure_injector(step)``, a library argument, runs
    before each step (a test's injected failure)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.pvq_qat and args.pvq_k is None:
        ap.error("--pvq-qat needs --pvq-k (the pulses per group of 256 of the STE projection)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the plain versions")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family in ("encdec", "vlm"):
        # the reference's train fails here later, in its forward
        # (KeyError: '0/encoder/final_norm/ln_bias', KeyError: 'patches')
        ap.error(f"--arch {args.arch}: the token loader makes token batches only, no "
                 f"{'frames' if cfg.family == 'encdec' else 'patches'}; "
                 "train it through Model.loss with your own batches")
    model = build_model(cfg)
    optimizer = AdamW(lr=cosine_schedule(args.lr, warmup=20, total=args.steps))
    state, step_fn = make_state_and_step(
        model, optimizer, pvq_qat=args.pvq_qat, pvq_k=args.pvq_k, seed=args.seed, device=device
    )

    task = TokenTask(cfg.vocab_size, seed=args.seed)
    loader = TokenLoader(task, args.batch, args.seq, seed=args.seed, device=device)
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_torch_train", cfg.name)
    ckpt = Checkpointer(ckpt_dir, keep=3)
    runner = TrainingRunner(
        step_fn, state, loader, ckpt, ckpt_every=args.ckpt_every,
        straggler=StragglerPolicy(),
    )

    t0 = time.time()
    runner.run(args.steps, failure_injector=failure_injector)
    dt = time.time() - t0
    hist = runner.history
    first = sum(h["loss"] for h in hist[:10]) / max(len(hist[:10]), 1)
    last = sum(h["loss"] for h in hist[-10:]) / max(len(hist[-10:]), 1)
    report = {
        "arch": cfg.name, "steps": len(hist), "wall_s": round(dt, 1),
        "loss_first10": round(first, 4), "loss_last10": round(last, 4),
        "stragglers_flagged": len(runner.straggler.flagged),
        "restores": runner.restores,
    }
    if return_state:
        return report, 0, {"model": model, "optimizer": optimizer, "runner": runner,
                           "checkpointer": ckpt, "step_fn": step_fn, "loader": loader,
                           "args": args}
    return report, 0


def main(argv=None) -> int:
    report, rc = run(argv)
    print(json.dumps(report))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
