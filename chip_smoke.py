#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one summary line each:

  0. the card's name and power limit (``nvidia-smi``), torch, CUDA and
     Python versions;
  1. build ``src/repro_torch/kernels/csrc/ring_q.cu`` with nvcc for
     sm_90a (time and the ``-Xptxas -v`` lines);
  2. every hand-written kernel against its plain PyTorch version on the
     card, bitwise: on every DS-CNN op and on the edge cases of
     ``repro_torch.kernels.cases``;
  3. the main path: ``repro_torch.load(artifact).run(x)`` on the card
     for the 8 golden inputs, batched and one by one, with the launch
     counts set to 0 just before and read just after; the float
     outputs, int8 outputs and final-pool sha256 must equal the golden
     that the reference wrote;
  4. timing: per-inference host-clock latency at batch 1 and 8, the
     device-busy share from ``torch.profiler``, and per kernel its
     CUDA-event time, its plain version's time and its bound.

Then one JSON line per kernel set (``{"kernels": [...]}``), the card's
name and power limit, and last ``{"ok": true, "device": {...}}``.  Any
mismatch, a failed build or launch, a missing card, or a run outside a
checkout exits nonzero and prints no result.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
ASSETS = ROOT / "src" / "repro_torch" / "assets"
ARTIFACT = ASSETS / "ds-cnn.cortex-m4.int8.json"
GOLDEN = ASSETS / "ds-cnn.cortex-m4.int8.golden.npz"
SOURCE = "src/repro_torch/kernels/csrc/ring_q.cu"

#: The TPU kernel each CUDA kernel replaces.
REPLACES = {
    "ring_gemm_q": "src/repro/kernels/quantized.py:87",
    "ring_conv_pw_q": "src/repro/kernels/quantized.py:196",
    "ring_conv_dw_q": "src/repro/kernels/quantized.py:310",
    "ring_conv_k2d_q": "src/repro/kernels/quantized.py:419",
    "ring_avgpool_q": "src/repro/kernels/quantized.py:603",
}

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15


def say(*args) -> None:
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Bounds: bytes moved once and int8 operations, from a kernel call's shapes.
# ---------------------------------------------------------------------------

def _segs(d: int) -> int:
    return -(-d // 128)


def work(kernel: str, kw: dict) -> tuple[int, int]:
    """``(bytes, ops)`` a kernel call must move and do: every input row
    read once, every output row written once (whole segments), weights,
    biases and requant constants once; 2 ops per MAC at in-bounds taps
    (1 per add for the average pool)."""
    from repro_torch.core.rowsched import conv_k2d_pad, conv_k2d_pad_w

    if kernel == "ring_avgpool_q":
        rows = kw["h"] * kw["w"]
        return (rows + 1) * _segs(kw["c"]) * 128, rows * kw["c"]
    if kernel == "ring_gemm_q":
        m, ci, co = kw["m_rows"], kw["d_in"], kw["d_out"]
        return ((m * _segs(ci) + m * _segs(co)) * 128 + ci * co + 12 * co,
                2 * m * ci * co)
    ci = kw["c"] if kernel == "ring_conv_dw_q" else kw["c_in"]
    co = kw["c"] if kernel == "ring_conv_dw_q" else kw["c_out"]
    rows_in, rows_out = kw["h_in"] * kw["w_in"], kw["h_out"] * kw["w_out"]
    io = (rows_in * _segs(ci) + rows_out * _segs(co)) * 128 + 12 * co
    if kernel == "ring_conv_pw_q":
        return io + ci * co, 2 * rows_out * ci * co
    k = kw["rs"] if kernel == "ring_conv_dw_q" else kw["k"]
    s, pad = kw["stride"], kw["padding"]
    pv, ph = conv_k2d_pad(k, pad), conv_k2d_pad_w(k, pad)
    rows_ok = [sum(0 <= p * s - pv + r < kw["h_in"] for r in range(k))
               for p in range(kw["h_out"])]
    cols_ok = [sum(0 <= q * s - ph + t < kw["w_in"] for t in range(k))
               for q in range(kw["w_out"])]
    taps = sum(rows_ok) * sum(cols_ok)
    if kernel == "ring_conv_dw_q":
        return io + k * k * ci, 2 * taps * ci
    return io + k * k * ci * co, 2 * taps * ci * co


def bound(kernel: str, kw: dict) -> tuple[float, str]:
    nbytes, ops = work(kernel, kw)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels._build import library

    lib, b = library()
    how = f"nvcc {b.seconds:.2f} s" if b.compiled else "already built"
    say(f"phase 1: built {b.path.name} for sm_90a ({how})")
    for line in b.ptxas_lines:
        say(f"  {line}")
    return lib


def _cuda(arrays):
    return tuple(torch.from_numpy(a).cuda() for a in arrays)


def phase_parity(cases) -> dict[str, int]:
    """Every case: kernel vs plain version on the card, bitwise.
    Returns the max |difference| per kernel (0, or this raises)."""
    from repro_torch.kernels import quantized as qk
    from repro_torch.kernels.cases import case_inputs

    say(f"phase 2: {len(cases)} kernel calls against their plain versions "
        "on the card (bitwise)")
    err: dict[str, int] = {name: 0 for name in qk.KERNELS}
    for case in cases:
        pool, params = case_inputs(case, seed=0)
        want = torch.from_numpy(pool).cuda()
        qk.PLAIN[case.kernel](want, *_cuda(params), **case.kwargs)
        got = torch.from_numpy(pool).cuda()
        qk.KERNELS[case.kernel](got, *_cuda(params), **case.kwargs)
        torch.cuda.synchronize()
        diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
        err[case.kernel] = max(err[case.kernel], int(diff.max()))
        if not torch.equal(got, want):
            seg = int(diff.amax(dim=1).nonzero()[0])
            raise SystemExit(f"{case.name}: {case.kernel} differs from its "
                             f"plain version, first at segment {seg}")
        say(f"  {case.name:18s} {case.kernel:16s} bitwise equal")
    return err


def phase_main_path(cn, golden) -> dict[str, int]:
    """The served path on the card; returns the launch counts of its run."""
    from repro_torch.compile.artifact import to_device
    from repro_torch.core.executors import run_program
    from repro_torch.kernels import quantized as qk
    from repro_torch.quant.qtensor import QParams, quantize

    x = torch.from_numpy(golden["x"]).cuda()
    qk.reset_launch_counts()
    y_batch = cn.run(x)
    y_single = [cn.run(xi) for xi in x]
    torch.cuda.synchronize()
    counts = qk.launch_counts()
    say(f"phase 3: main path, repro_torch.load(plan).run(x) on "
        f"{y_batch.device}: 8 inputs batched + 8 one by one")
    say(f"  launches: {counts}")
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise SystemExit(f"kernels never launched on the main path: "
                         f"{missing}")
    want = torch.from_numpy(golden["y"]).cuda()
    if not torch.equal(y_batch, want):
        raise SystemExit("batched float outputs differ from the golden")
    for i, y in enumerate(y_single):
        if not torch.equal(y, want[i]):
            raise SystemExit(f"float output {i} differs from the golden")
    qparams = to_device(cn.qnet.qparams, "cuda")
    for i, xi in enumerate(x):
        xq = quantize(xi, QParams(scale=cn.qnet.in_scale))
        y_q, pool = run_program(cn.program, xq, qparams,
                                kernel_block_rows=cn.target.kernel_block_rows)
        if not np.array_equal(y_q.cpu().numpy(), golden["y_q"][i]):
            raise SystemExit(f"int8 output {i} differs from the golden")
        sha = hashlib.sha256(pool.array.cpu().numpy().tobytes()).hexdigest()
        if sha != golden["pool_sha256"][i]:
            raise SystemExit(f"final pool {i} differs from the golden")
    say(f"  {tuple(y_batch.shape)} {y_batch.dtype}: float outputs, int8 "
        "outputs and final-pool sha256 equal the golden on all 8")
    return counts


def _event_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of ``fn()`` over ``reps`` back-to-back calls
    (the plain versions: host and device time together)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _held_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls.

    The stream first spins long enough for the host to enqueue every
    call before the card reaches the first, so the events time the
    kernels alone and not the host's launch rate.  The spin grows until
    it outlasts the enqueue."""
    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        held = not start.query()
        end.record()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise SystemExit(f"the stream hold never outlasted the host's enqueue "
                     f"({enqueue_ms:.2f} ms for {reps} calls)")


def _host_ms(fn, reps: int) -> float:
    """Median host-clock time of ``fn()`` followed by a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


#: Each wrapper's CUDA kernel, as the profiler names it.
KERNEL_SYMBOLS = {"ring_gemm_q": "gemm_kernel",
                  "ring_conv_pw_q": "conv_pw_kernel",
                  "ring_conv_dw_q": "conv_dw_kernel",
                  "ring_conv_k2d_q": "conv_k2d_kernel",
                  "ring_avgpool_q": "avgpool_kernel"}


def _device_busy(cn, x1, reps: int = 20):
    """From torch.profiler over ``reps`` batch-1 runs: the device time
    of all kernels over the wall time (None when the profiler sees no
    device time), the wall time per run in us, and each ring kernel's
    mean device time per launch in ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cn.run(x1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            cn.run(x1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    per_launch = {}
    for name, sym in KERNEL_SYMBOLS.items():
        hits = [e for e in kernels if sym + "(" in e.key]
        calls = sum(e.count for e in hits)
        if calls:
            per_launch[name] = sum(e.self_device_time_total
                                   for e in hits) / calls / 1e3
    return ((busy_us / wall_us if busy_us > 0 else None), wall_us / reps,
            per_launch)


def phase_timing(cn, golden, ds_cnn_cases, counts, errs) -> list[dict]:
    from repro_torch.kernels import quantized as qk
    from repro_torch.kernels.cases import case_inputs

    say("phase 4: timing")
    rows = []
    n_inf = 16                       # the main path ran 8 + 8 inferences
    for name in qk.KERNELS:
        ms, plain_ms, host_ms, bounds = [], [], [], []
        for case in (c for c in ds_cnn_cases if c.kernel == name):
            pool, params = case_inputs(case, seed=0)
            pool, params = torch.from_numpy(pool).cuda(), _cuda(params)
            kern, plain = qk.KERNELS[name], qk.PLAIN[name]
            host_ms.append(_host_ms(
                lambda: kern(pool, *params, **case.kwargs), 50))
            ms.append(_held_ms(lambda: kern(pool, *params, **case.kwargs),
                               100))
            plain_ms.append(_event_ms(
                lambda: plain(pool, *params, **case.kwargs), 10))
            bounds.append(bound(name, case.kwargs))
        bound_ms = statistics.mean(b for b, _ in bounds)
        row = {"name": name, "route": "cuda", "source": SOURCE,
               "replaces": REPLACES[name], "launches": counts[name],
               "max_abs_err": errs[name], "ms": statistics.mean(ms),
               "plain_ms": statistics.mean(plain_ms), "bound_ms": bound_ms,
               "bound_by": bounds[0][1], "library_ms": None,
               "launches_per_inference": counts[name] / n_inf,
               "host_ms": statistics.mean(host_ms)}
        rows.append(row)
        say(f"  {name:16s} {row['ms'] * 1e3:9.2f} us/launch (device), "
            f"{row['host_ms'] * 1e3:8.2f} us with launch (host), plain "
            f"{row['plain_ms'] * 1e3:9.2f} us, bound "
            f"{bound_ms * 1e3:.4f} us ({row['bound_by']}), "
            f"{row['launches_per_inference']:g} per inference")
    x = torch.from_numpy(golden["x"]).cuda()
    b1 = _host_ms(lambda: cn.run(x[0]), 50)
    b8 = _host_ms(lambda: cn.run(x), 20) / 8
    busy, window_us, prof_ms = _device_busy(cn, x[0])
    busy_txt = "not measured" if busy is None else f"{busy:.4f}"
    say(f"  per inference {b1:.4f} ms at batch 1, {b8:.4f} ms at batch 8 "
        f"(host clock, ending in synchronize); device busy {busy_txt} of "
        f"{window_us:.1f} us per batch-1 run (profiler)")
    for row in rows:
        row["profiler_ms"] = prof_ms.get(row["name"])
    say("  profiler device time per launch on the main path (us): "
        + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in prof_ms.items()))
    return rows


def main() -> None:
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit("chip_smoke.py runs from the root of a checkout "
                         "that holds src/repro_torch")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; none is "
                         "available")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    from repro_torch.kernels.cases import EDGE_CASES, program_cases

    card = nvidia_smi_line()
    say(f"phase 0: card {card}")
    say(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")
    phase_build()

    cn = repro_torch.load(ARTIFACT)
    with np.load(GOLDEN) as g:
        golden = {k: g[k] for k in g.files}
    ds_cnn = program_cases(cn.program, cn.qnet.qparams,
                           kernel_block_rows=cn.target.kernel_block_rows)
    errs = phase_parity(ds_cnn + EDGE_CASES)
    counts = phase_main_path(cn, golden)
    rows = phase_timing(cn, golden, ds_cnn, counts, errs)

    say(json.dumps({"kernels": rows}))
    say(nvidia_smi_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
