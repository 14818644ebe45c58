"""The serving command: batched generation through the ring-KV engine (the
port of ``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch gemma3-1b [--reduced]
        [--batch 4] [--prompt-len 32] [--max-new 16] [--device cuda|cpu]

The params are ``Model.init`` of a generator seeded 0 on ``--device``
(the card unless ``--device cpu``; without a card it exits nonzero).  A
config with cross blocks attends to memory drawn from the same generator
(``[batch, memory_len, d_model]``, N(0, 1): encoder frames or image
tokens), which the reference's command does not supply.
Prints the reference's lines: tokens and seconds, then the first two
requests' first 12 tokens.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config
from ..models import build_model, params_from_reference
from ..models.common import normal
from ..serve.engine import ServingEngine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: run on one, or pass --device cpu")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = params_from_reference(cfg, model.init(gen), args.device)
    memory = None
    if cfg.memory_len():
        memory = normal(gen, (args.batch, cfg.memory_len(), cfg.d_model))
    engine = ServingEngine(model, params,
                           cache_len=args.prompt_len + args.max_new + 8)
    prompts = [[(7 * i + j) % cfg.vocab for j in range(args.prompt_len)]
               for i in range(args.batch)]
    t0 = time.time()
    outs = engine.generate(prompts, max_new=args.max_new, memory=memory)
    dt = time.time() - t0
    toks = args.batch * args.max_new
    print(f"generated {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s batch={args.batch})")
    for i, o in enumerate(outs[:2]):
        print(f"  req{i}: {o[:12]}...")


if __name__ == "__main__":
    main()
