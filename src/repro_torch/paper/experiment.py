"""The paper's §VII experiments, end to end (port of ``repro.paper.experiment``).

Pipeline per net (A/B/C/D):
  1. train the float net (ReLU, or bsign with its STE) on the synthetic
     classify task (``data.synthetic``: the MNIST/CIFAR stand-ins);
  2. PVQ-encode each weight layer with the paper's per-layer N/K ratios
     (weights flattened + bias appended, ONE rho per layer);
  3. evaluate before/after: the paper's headline "few % drop";
  4. verify the §V folding claims (integer-only forward + one output scale
     == dequantized forward; argmax invariance);
  5. collect the Tables 5-8 pulse statistics and §VI bits/weight estimates.

Training is an eager autograd loop on the given device (the card unless the
caller passes ``device="cpu"``) with the reference's AdamW rule; the float
convs and matmuls, forward and backward, run in full f32.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs.paper_nets import PAPER_NETS
from ..core.codes import compression_report, pulse_histogram
from ..core.qat import pvq_ste
from ..core.quantize import k_for
from ..data.synthetic import ClassifyTask
from ..nn.sequential import SequentialNet, accuracy, full_f32, xent_loss
from ..optim.adamw import AdamW, tree_leaves, tree_map


@dataclasses.dataclass
class RepoResult:
    net: str
    acc_before: float
    acc_after: float
    acc_after_ls: float  # beyond-paper least-squares rho
    acc_refined: Optional[float]  # paper §IV hybrid recipe (PVQ-constrained fine-tune)
    drop_pct: float
    layer_stats: Dict[str, Dict[str, Any]]
    weight_tables: Dict[str, Dict[str, float]]
    fold_check: Optional[Dict[str, float]]
    train_steps: int
    wall_s: float
    train_s: float = 0.0  # the float training alone, the device synchronised


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _batch(task: ClassifyTask, rng: np.random.Generator, n: int, shape, device):
    b = task.sample(rng, n)  # f64 x, taken to f32 as the reference's jnp.asarray does
    return {"x": torch.from_numpy(b["x"]).to(device, torch.float32).reshape(n, *shape),
            "y": torch.from_numpy(b["y"]).to(device)}


def _project(net: SequentialNet, p):
    """The paper's §IV mixed optimization: every PVQ layer's weights+bias
    projected onto its pyramid in the forward, the gradient passed straight
    through (``pvq_ste``)."""
    out = dict(p)
    for i, spec in enumerate(net.cfg.layers):
        pname = f"layer{i}"
        if pname in p and spec.n_over_k is not None:
            kern, bias = p[pname]["kernel"], p[pname]["bias"]
            k = k_for(kern.numel() + bias.numel(), spec.n_over_k)
            q = pvq_ste(torch.cat([kern.reshape(-1), bias]), k, None)
            out[pname] = {"kernel": q[: kern.numel()].reshape(kern.shape),
                          "bias": q[kern.numel():]}
    return out


def train_net(
    net: SequentialNet,
    task: ClassifyTask,
    *,
    steps: int = 300,
    batch: int = 128,
    lr: float = 1e-3,
    weight_decay: float = 0.05,  # paper: L2 helps sparsify for PVQ
    seed: int = 0,
    init_params=None,
    pvq_project: bool = False,
    device="cuda",
):
    """Train (or fine-tune) the net; ``pvq_project=True`` runs the paper's
    §IV mixed optimization.  Batches come from ``np.random.default_rng(seed)``
    (the reference's batches), dropout from a ``torch.Generator`` seeded
    with ``seed + 1``.  ``init_params`` (on their own device) replace the
    init from ``seed``."""
    if init_params is not None:
        params = init_params
        device = tree_leaves(params)[0].device
    else:
        params = net.init(seed, device=device)
    opt = AdamW(lr=lr, weight_decay=weight_decay, clip_norm=1.0)
    state = opt.init(params)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    for _ in range(steps):
        b = _batch(task, rng, batch, net.cfg.input_shape, device)
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with full_f32():
            p = _project(net, leaves) if pvq_project else leaves
            xent_loss(net, p, b, generator=gen).backward()
        grads = tree_map(lambda t: t.grad, leaves)
        params, state, _ = opt.update(grads, state, tree_map(lambda t: t.detach(), leaves))
    return params


def _evaluate(net: SequentialNet, task: ClassifyTask, params, *, batch: int = 128,
              seed: int = 0, check_fold: bool = True, refine_steps: int = 0) -> Dict[str, Any]:
    """``run_net``'s half after the float training, on ``params`` (on their
    own device): the whole-layer PVQ, the accuracies, the optional §IV
    refinement, the Tables 5-8 statistics and the §V fold check.  Returns
    the matching ``RepoResult`` fields."""
    device = tree_leaves(params)[0].device
    cfg = net.cfg
    test = task.test_set(2048)
    xt = torch.from_numpy(test["x"]).to(device, torch.float32).reshape(-1, *cfg.input_shape)
    yt = torch.from_numpy(test["y"]).to(device)
    acc_before = accuracy(net, params, xt, yt)

    with torch.no_grad():
        qparams, codes, stats = net.pvq_encode_layers(params, scale_mode="paper")
        qparams_ls, _, _ = net.pvq_encode_layers(params, scale_mode="ls")
    acc_after = accuracy(net, qparams, xt, yt)
    acc_after_ls = accuracy(net, qparams_ls, xt, yt)

    acc_refined = None
    if refine_steps:
        refined = train_net(net, task, steps=refine_steps, batch=batch, lr=2e-4,
                            seed=seed + 99, init_params=params, pvq_project=True)
        with torch.no_grad():
            rq, _, _ = net.pvq_encode_layers(refined, scale_mode="paper")
        acc_refined = accuracy(net, rq, xt, yt)

    weight_tables = {}
    for lname, code in codes.items():
        pulses = code.pulses.cpu().numpy().ravel()
        rep = pulse_histogram(pulses)
        rep.update(compression_report(pulses))
        weight_tables[lname] = rep

    fold_check = None
    if check_fold:
        # §V: integer pulse forward * one scale == dequantized forward
        with torch.no_grad():
            logits_deq = net.apply(qparams, xt[:64])
            logits_int, scale = net.integer_forward(params, codes, xt[:64])
        err = float(torch.max(torch.abs(scale * logits_int - logits_deq))
                    / torch.clamp(torch.max(torch.abs(logits_deq)), min=1e-9))
        same_argmax = float(torch.mean(
            (torch.argmax(logits_int, -1) == torch.argmax(logits_deq, -1)).to(torch.float32)))
        fold_check = {"rel_err": err, "argmax_agreement": same_argmax, "output_scale": scale}

    return dict(acc_before=acc_before, acc_after=acc_after, acc_after_ls=acc_after_ls,
                acc_refined=acc_refined, drop_pct=100.0 * (acc_before - acc_after),
                layer_stats=stats, weight_tables=weight_tables, fold_check=fold_check)


def run_net(
    net_id: str,
    *,
    steps: int = 600,
    batch: int = 128,
    noise: float = 6.0,
    seed: int = 0,
    check_fold: bool = True,
    refine_steps: int = 0,
    device="cuda",
) -> RepoResult:
    t0 = time.time()
    cfg = PAPER_NETS[net_id]
    net = SequentialNet(cfg)
    task = ClassifyTask(cfg.input_shape, n_classes=cfg.n_classes, noise=noise, seed=seed)
    _sync(device)
    t_train = time.time()
    params = train_net(net, task, steps=steps, batch=batch, seed=seed, device=device)
    _sync(device)
    train_s = time.time() - t_train
    out = _evaluate(net, task, params, batch=batch, seed=seed, check_fold=check_fold,
                    refine_steps=refine_steps)
    return RepoResult(net=net_id, **out, train_steps=steps, wall_s=time.time() - t0,
                      train_s=train_s)


def format_result(r: RepoResult) -> str:
    lines = [
        f"== net {r.net} ==",
        f"accuracy before PVQ: {100*r.acc_before:.2f}%   after: {100*r.acc_after:.2f}%"
        f"   (drop {r.drop_pct:.2f} pts; paper reports a few % drop)",
        f"beyond-paper LS-scale after: {100*r.acc_after_ls:.2f}%",
    ]
    if r.acc_refined is not None:
        lines.append(f"hybrid refine (paper §IV): {100*r.acc_refined:.2f}%")
    if r.fold_check:
        lines.append(
            f"rho-folding: integer-path rel err {r.fold_check['rel_err']:.2e}, "
            f"argmax agreement {100*r.fold_check['argmax_agreement']:.1f}%, "
            f"output scale {r.fold_check['output_scale']:.4g}"
        )
    for lname, st in r.layer_stats.items():
        tab = r.weight_tables[lname]
        lines.append(
            f"  {lname}: N={st['N']} K={st['K']} N/K={st['n_over_k']:.2g} | "
            f"zeros {tab['0_pct']:.1f}% ±1 {tab['+-1_pct']:.1f}% ±2..3 {tab['+-2..3_pct']:.1f}% | "
            f"golomb {tab['golomb_bits_per_weight']:.2f} b/w"
        )
    return "\n".join(lines)
