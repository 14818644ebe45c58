"""The training driver with fault tolerance (the port of
``repro.launch.train``), on one device or, through ``train_loop(...,
rules=)``, on a mesh:

    python -m repro_torch.launch.train --arch gemma3-1b [--reduced]
        [--steps 200] [--batch 8] [--seq 128] [--ckpt-dir DIR]
        [--microbatches 1] [--device cuda|cpu]

The device is the card unless ``--device cpu`` (without a card the
command exits nonzero).  What it keeps of the reference's loop:

* checkpoint/restart: the atomic ``CheckpointManager``; a run resumes
  from the latest step under ``ckpt_dir``, placed onto the mesh where
  there is one (elastic restore);
* deterministic data: batches are a pure function of the step, so a
  restart replays exactly;
* preemption: SIGTERM sets a flag, and the loop checkpoints and stops
  at the next step boundary; the handler that was installed before the
  loop is put back when it returns;
* async checkpointing: the save thread overlaps the next steps;
* straggler guard: a step slower than ``straggler_factor`` times the
  median of the steps so far (once there are more than 8) is counted.
"""
from __future__ import annotations

import argparse
import signal
import statistics
import time

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..configs import get_config
from ..models.registry import build_model
from ..parallel.sharding import AxisRules, no_sharding, place_tree
from ..train.data import sharded_batch, synthetic_batch
from ..train.optimizer import AdamWConfig, init_state
from ..train.train_step import (eval_state_shapes, init_train_state,
                                make_train_step)
from ..train.tree import map_with_path

_PREEMPTED = False


def _on_sigterm(signum, frame):  # noqa: ANN001
    global _PREEMPTED
    _PREEMPTED = True


def _params_on(params, device):
    """A params tree (numpy or torch leaves) as fp32 tensors of its own
    on ``device``."""
    def put(_, a):
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.array(a, np.float32))
        return a.detach().to(device=device, dtype=torch.float32, copy=True)
    return map_with_path(put, params)


def train_loop(cfg, *, steps: int, batch: int, seq: int, ckpt_dir: str,
               ckpt_every: int = 50, rules: AxisRules | None = None,
               microbatches: int = 1, log_every: int = 10,
               straggler_factor: float = 3.0, device="cuda",
               params=None) -> dict:
    """Train ``cfg`` for ``steps`` steps (resuming from the latest
    checkpoint under ``ckpt_dir``) -> {"final_loss", "first_loss",
    "stragglers", "median_step_s"}.  A fresh run starts from ``params``
    (a reference-layout tree, numpy or torch, e.g. the reference's own
    ``Model.init`` or ``cases.lm_params``) or, where it is None, from
    ``Model.init`` of a ``torch.Generator`` seeded 0.  On a mesh
    (``rules`` with one; every rank of it runs the loop) the state is
    placed by ``rules.params_shardings``, each batch comes by
    ``sharded_batch`` and a restart restores onto the mesh."""
    rules = rules or no_sharding()
    model = build_model(cfg)
    opt = AdamWConfig(peak_lr=3e-4, warmup_steps=max(10, steps // 20),
                      total_steps=steps)
    step_fn = make_train_step(model, rules, opt=opt,
                              microbatches=microbatches)
    mgr = CheckpointManager(ckpt_dir)
    like = eval_state_shapes(model)
    shardings = like._replace(
        step=None, params=rules.params_shardings(like.params),
        mu=rules.params_shardings(like.mu),
        nu=rules.params_shardings(like.nu))
    rows = {"tokens": rules.sharding("batch", None),
            "labels": rules.sharding("batch", None),
            "memory": rules.sharding("batch", None, None)}

    start = mgr.latest_step()
    if start is None:
        if params is None:
            gen = torch.Generator(device=device).manual_seed(0)
            state = init_train_state(model, gen)
        else:
            state = init_state(_params_on(params, device))
        state = place_tree(state, shardings)
        start = 0
    else:
        state = mgr.restore(like, device=device, shardings=shardings)
        print(f"[restore] resumed from step {start}")

    previous = signal.signal(signal.SIGTERM, _on_sigterm)
    losses, times, stragglers = [], [], 0
    step = start
    try:
        for step in range(start, steps):
            b = synthetic_batch(cfg, batch, seq, step, device=device) \
                if rules.mesh is None else \
                sharded_batch(cfg, batch, seq, step, rows)
            t0 = time.time()
            state, metrics = step_fn(state, b)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            losses.append(loss)
            times.append(dt)
            if len(times) > 8 and \
                    dt > straggler_factor * statistics.median(times):
                stragglers += 1
            if step % log_every == 0:
                print(f"step {step:5d} loss {loss:8.4f} "
                      f"gnorm {float(metrics['grad_norm']):8.3f} "
                      f"{dt * 1e3:7.1f}ms", flush=True)
            if (step + 1) % ckpt_every == 0 or _PREEMPTED:
                mgr.save_async(step + 1, state, {"loss": loss})
            if _PREEMPTED:
                mgr.wait()
                print(f"[preempt] checkpointed at {step + 1}, exiting")
                break
        mgr.wait()
        mgr.save(steps if not _PREEMPTED else step + 1, state,
                 {"loss": losses[-1] if losses else float("nan")})
    finally:
        signal.signal(signal.SIGTERM, previous)
    return {"final_loss": losses[-1] if losses else float("nan"),
            "first_loss": losses[0] if losses else float("nan"),
            "stragglers": stragglers,
            "median_step_s": statistics.median(times) if times else 0.0}


def build_parser() -> argparse.ArgumentParser:
    """The command's arguments; ``--ckpt-dir`` defaults to the
    reference's ``/tmp/repro_ckpt``."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: run on one, or pass --device cpu")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    out = train_loop(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                     ckpt_dir=args.ckpt_dir, microbatches=args.microbatches,
                     device=args.device)
    print(out)


if __name__ == "__main__":
    main()
