"""Multi-rank programs of the port's tests, run over ``gloo`` on the CPU.

    python tests/_torch_mesh_worker.py <task> <args.json>

starts ``world`` processes (``torch.multiprocessing.spawn``), joined by a
``FileStore`` in the job's directory (no TCP port, so pytest's workers
never collide), runs ``task`` on every rank and lets rank 0 write the
results where ``args.json`` says.  Tasks:

* ``steps``: the port's ``launch.steps`` train, prefill and decode steps on
  a ``(data, model)`` debug mesh, from the params and batches in
  ``inputs`` (numpy, the reference's init);
* ``pipeline``: ``parallel.pipeline.pipeline_forward`` over a ``pod`` mesh;
* ``cross_pod``: ``optim.grad_compress.cross_pod_mean`` over a ``pod`` mesh.

It imports no JAX: the tests hold its outputs to the reference.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _unflat(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _np(t):
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().to(torch.float32).numpy() if t.is_floating_point() else t.numpy()


def _cfg(arch, jitter):
    from repro_torch.configs import get_config

    cfg = get_config(arch).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=cfg.moe._replace(router_jitter=jitter))
    return cfg


def task_steps(rank, args):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import make_step
    from repro_torch.nn.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.parallel.sharding import distribute, full_tree

    mesh = make_debug_mesh(args["n_data"], args["n_model"], device_type="cpu")
    data = dict(np.load(args["inputs"]))
    out = {}
    for arch in args["archs"]:
        cfg = _cfg(arch, 0.0)
        model = build_model(cfg)
        params = _unflat({k[len(arch) + 8:]: torch.from_numpy(v) for k, v in data.items()
                          if k.startswith(f"{arch}/params/")})
        b, s = data[f"{arch}/tokens"].shape
        tokens = torch.from_numpy(data[f"{arch}/tokens"]).to(torch.int64)
        targets = torch.from_numpy(data[f"{arch}/targets"]).to(torch.int64)
        for opt in args["opt_levels"]:
            tag = f"{arch}/{opt}"
            # train: two steps
            shape = ShapeConfig("t", "train", s, b)
            bundle = make_step(model, mesh, shape, opt_level=opt)
            state = bundle.distribute(params, AdamW().init(params),
                                      {"tokens": tokens, "targets": targets})
            p, o, batch = state
            for step in range(2):
                p, o, metrics = bundle.run(p, o, batch)
                for k, v in metrics.items():
                    out[f"{tag}/train/{step}/{k}"] = _np(v)
            for k, v in _flat(full_tree(p)).items():
                out[f"{tag}/train/params/{k}"] = _np(v)
            # prefill
            shape = ShapeConfig("p", "prefill", s, b)
            bundle = make_step(model, mesh, shape, opt_level=opt)
            logits, caches = bundle.run(*bundle.distribute(params, {"tokens": tokens}))
            out[f"{tag}/prefill/logits"] = _np(logits)
            # decode: the prompt a token at a time from a zero cache, then greedy
            steps, gen = s, args["gen"]
            shape = ShapeConfig("d", "decode", steps + gen, b)
            bundle = make_step(model, mesh, shape, opt_level=opt)
            cache = model.init_cache(b, steps + gen, device="cpu")
            pp, cache, _, _ = bundle.distribute(params, cache, tokens[:, :1], 0)
            tok = tokens[:, :1]
            outs, logs = [], []
            for i in range(steps + gen):
                logits, cache = bundle.run(pp, cache, distribute(tok, bundle.in_shardings[2]), i)
                lg = _np(logits)[:, -1]
                logs.append(lg)
                nxt = torch.from_numpy(lg.argmax(-1)).to(torch.int64)[:, None]
                tok = tokens[:, i + 1 : i + 2] if i + 1 < steps else nxt
                outs.append(tok.numpy())
            out[f"{tag}/decode/logits"] = np.stack(logs, 1)
            out[f"{tag}/decode/tokens"] = np.concatenate(outs[steps - 1 :], 1)
    return out


def task_pipeline(rank, args):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.parallel.pipeline import pipeline_forward

    data = np.load(args["inputs"])
    ws = torch.from_numpy(data["ws"])
    xs = torch.from_numpy(data["xs"])
    mesh = init_device_mesh("cpu", (ws.shape[0],), mesh_dim_names=("pod",))
    out = pipeline_forward(lambda w, x: torch.tanh(x @ w), ws[rank], xs, mesh=mesh, axis="pod")
    return {"out": out.numpy(), "rank": np.asarray(rank)}


def task_cross_pod(rank, args):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.packed import pack_matmul
    from repro_torch.optim.grad_compress import CompressionConfig, cross_pod_mean

    data = np.load(args["inputs"])
    mesh = init_device_mesh("cpu", (args["world"],), mesh_dim_names=("pod",))
    res = {}
    for name, kw in args["configs"].items():
        cfg = CompressionConfig(**kw)
        grads = {"g": torch.from_numpy(data[f"g{rank}"]),
                 "small": torch.from_numpy(data[f"small{rank}"])}
        if name == "default":
            packed = pack_matmul(torch.from_numpy(data["w"]), group=32, n_over_k=1.0)
            grads["packed"] = packed
        out = cross_pod_mean(grads, cfg, mesh=mesh, axis="pod")
        res[f"{name}/g"] = out["g"].numpy()
        res[f"{name}/small"] = out["small"].numpy()
        if name == "default":
            res[f"{name}/packed_same"] = np.asarray(out["packed"] is packed)
    # no such axis: the identity
    none = cross_pod_mean({"g": torch.from_numpy(data[f"g{rank}"])},
                          CompressionConfig(group=128, n_over_k=0.25, min_size=128),
                          mesh=mesh, axis="data")
    res["no_axis/g"] = none["g"].numpy()
    return res


TASKS = {"steps": task_steps, "pipeline": task_pipeline, "cross_pod": task_cross_pod}


def _run(rank, task, args):
    try:
        dist.init_process_group("gloo", init_method=f"file://{args['store']}", rank=rank,
                                world_size=args["world"])
        torch.manual_seed(0)
        out = TASKS[task](rank, args)
        if rank == 0:
            np.savez(args["out"], **out)
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def main() -> int:
    task, path = sys.argv[1], sys.argv[2]
    args = json.loads(open(path).read())
    torch.set_num_threads(1)
    torch.multiprocessing.spawn(_run, args=(task, args), nprocs=args["world"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
