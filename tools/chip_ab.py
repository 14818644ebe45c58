#!/usr/bin/env python3
"""Compare two checkouts of this repo on one CUDA card, in turns.

    python3 tools/chip_ab.py A_DIR B_DIR [--rounds N]

Each round runs A, B, B, A, each in a process of its own
(``--child DIR``), which builds that checkout's kernels and measures,
through that checkout's own ``repro_torch`` and ``chip_smoke.py``:

* the batch-1 latency of the int8 and fp32 paths (``run`` on DS-CNN,
  ResNet-8, MCUNet-5fps-VWW and ToyADMOS, ``stream().step`` on the DS-CNN
  stream and the GRU chain, each int8 on cortex-m4 and fp32 on
  host-sim): median and quartiles of 300 calls on the host clock, each
  ending in ``torch.cuda.synchronize()``, after 20 calls of warm-up;
* the device time of every ring kernel on every op of those plans (the
  eight int8 kernels and the fp32 FC, pw, dw, k x k and streaming convs,
  add, pool, bottleneck and GRU cell; ``chip_smoke._held_ms``:
  held-stream CUDA events, 50 launches).

With ``--lm`` each process instead draws gemma3-1b at full width
(``chip_smoke.lm_setup``) and times that checkout's model by this
script's own loop, the same for both: prefill of ``chip_smoke``'s 4
prompts at batch 4 (5 calls) and one decode step at batch 1 and 4 (20
calls), each the median on the host clock ending in synchronize
(``chip_smoke._host_ms``).

It prints each process's result as a JSON line, then a summary: per
path the median of the processes' medians, per op the mean of the
processes' times (``--lm``: the median of each timing and its
spread, the smallest and largest of the processes'), for A and for B.  Host times move between processes
and machines, so only an A/B inside one call counts.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

STREAM_PATHS = ("ds-cnn-stream", "kws-gru-chain")
INT8_PATHS = ("ds-cnn", "resnet-8", "mcunet-5fps-vww", "ad-toyadmos") \
    + STREAM_PATHS
#: Every path: the int8 plans, then the fp32 ones by chip_smoke.py's label
#: (the net's name + "-f32").
PATHS = INT8_PATHS + tuple(f"{p}-f32" for p in INT8_PATHS)
KERNELS = ("ring_conv_k2d_q", "ring_conv_pw_q", "ring_conv_dw_q",
           "ring_add_q", "ring_conv_stream_q", "ring_gemm_q",
           "ring_avgpool_q", "ring_gru_cell_q", "ring_gemm", "ring_conv_pw",
           "ring_conv_dw", "ring_conv_k2d", "ring_add", "ring_avgpool",
           "ring_inverted_bottleneck", "ring_conv_stream", "ring_gru_cell")
CALLS, WARM = 300, 20


def child(root: pathlib.Path) -> dict:
    import torch

    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke as cs
    from repro_torch.kernels import KERNELS as WRAPPERS
    from repro_torch.kernels.cases import case_inputs

    latency, kernel_us = {}, {}
    for name in PATHS:
        cn = cs.load_plan(name)
        golden = cs.load_golden(name, cn)
        if name.removesuffix("-f32") in STREAM_PATHS:
            session = cn.stream()
            frame = torch.from_numpy(
                golden["x_q" if cn.quantized else "x"][0]).cuda()
            fn = lambda s=session, f=frame: s.step(f)   # noqa: E731
        else:
            x1 = torch.from_numpy(golden["x"][0]).cuda()
            fn = lambda c=cn, x=x1: c.run(x)             # noqa: E731
        for _ in range(WARM):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(CALLS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        q = statistics.quantiles(times, n=4)
        latency[name] = [q[1], q[0], q[2]]
        for case in cs.plan_cases(name, cn):
            if case.kernel not in KERNELS:
                continue
            pool, params = case_inputs(case, seed=0)
            pool, params = torch.from_numpy(pool).cuda(), cs._cuda(params)
            wrapper = WRAPPERS[case.kernel]
            kernel_us[case.name] = cs._held_ms(
                lambda: wrapper(pool, *params, **case.kwargs), 50) * 1e3
    return {"root": str(root), "latency_ms": latency, "kernel_us": kernel_us}


def child_lm(root: pathlib.Path) -> dict:
    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke as cs

    from repro_torch.models import build_model

    cfg, params = cs.lm_setup()
    model = build_model(cfg)
    _, padded = cs.lm_prompts_of_path(cfg)
    out = {"prefill_ms_batch4": cs._host_ms(lambda: model.prefill(
        params, padded, cache_len=cs.LM_CACHE_LEN), 5)}
    for B in (1, len(padded)):
        logits, caches, cur = model.prefill(params, padded[-B:],
                                            cache_len=cs.LM_CACHE_LEN)
        tok = logits.argmax(-1)
        out[f"decode_ms_batch{B}"] = cs._host_ms(
            lambda: model.decode_step(params, caches, tok, cur), 20)
    return {"root": str(root), "lm": out}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="*", type=pathlib.Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", type=pathlib.Path)
    ap.add_argument("--lm", action="store_true")
    args = ap.parse_args()
    if args.child:
        fn = child_lm if args.lm else child
        print(json.dumps(fn(args.child.resolve())), flush=True)
        return
    if len(args.dirs) != 2:
        ap.error("give two checkouts, A and B")
    a, b = (d.resolve() for d in args.dirs)
    runs = {a: [], b: []}
    for _ in range(args.rounds):
        for root in (a, b, b, a):
            out = subprocess.run(
                [sys.executable, __file__, "--child", str(root)]
                + (["--lm"] if args.lm else []),
                capture_output=True, text=True, check=True)
            line = out.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            runs[root].append(json.loads(line))
    for label, root in (("A", a), ("B", b)):
        rs = runs[root]
        if args.lm:
            keys = [k for k in rs[0]["lm"] if all(
                isinstance(r["lm"].get(k), float) for r in rs)]
            print(json.dumps({label: str(root), "lm": {
                k: statistics.median(r["lm"][k] for r in rs)
                for k in keys}, "lm_min": {
                k: min(r["lm"][k] for r in rs) for k in keys}, "lm_max": {
                k: max(r["lm"][k] for r in rs) for k in keys}}),
                flush=True)
            continue
        lat = {p: statistics.median(r["latency_ms"][p][0] for r in rs)
               for p in PATHS}
        us = {op: statistics.mean(r["kernel_us"][op] for r in rs)
              for op in rs[0]["kernel_us"]}
        print(json.dumps({label: str(root), "latency_ms": lat,
                          "kernel_us": us}), flush=True)


if __name__ == "__main__":
    main()
