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
     card, bitwise: on every op of the five committed plans (DS-CNN,
     ResNet-8, MCUNet-5fps-VWW, the DS-CNN stream and the GRU chain) and
     on the edge cases of ``repro_torch.kernels.cases``; and which ops
     read their weights from global memory (too large for shared);
  3. the paths, each with the launch counts set to 0 just before it and
     read just after:
       * ``repro_torch.load(artifact).run(x)`` on DS-CNN, ResNet-8 and
         MCUNet-5fps-VWW for the 8 golden inputs, batched and one by
         one; float outputs, int8 outputs and final-pool sha256 equal
         the golden that the reference wrote;
       * ``CompiledNet.stream().step(frame)`` on the DS-CNN stream and
         the GRU chain for 60 frames; every step's int8 output and the
         final pool's sha256 equal the golden;
  4. timing: per-inference host-clock latency at batch 1 and 8 and
     per-step stream latency, the device-busy share of each path from
     ``torch.profiler``, and per kernel its CUDA-event time, its plain
     version's time and its bound, at the shapes each path gives it.

Then one JSON line with every kernel (``{"kernels": [...]}``), the
card's name and power limit, and last ``{"ok": true, "device": {...}}``.
Any mismatch, a failed build or launch, a missing card, or a run outside
a checkout exits nonzero and prints no result.
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
SOURCE = "src/repro_torch/kernels/csrc/ring_q.cu"
#: Plans served by ``run`` and plans stepped by ``stream``.
NETS = ("ds-cnn", "resnet-8", "mcunet-5fps-vww")
STREAMS = ("ds-cnn-stream", "kws-gru-chain")

#: The TPU kernel each CUDA kernel replaces.
REPLACES = {
    "ring_gemm_q": "src/repro/kernels/quantized.py:87",
    "ring_conv_pw_q": "src/repro/kernels/quantized.py:196",
    "ring_conv_dw_q": "src/repro/kernels/quantized.py:310",
    "ring_conv_k2d_q": "src/repro/kernels/quantized.py:419",
    "ring_add_q": "src/repro/kernels/quantized.py:515",
    "ring_avgpool_q": "src/repro/kernels/quantized.py:603",
    "ring_conv_stream_q": "src/repro/kernels/stream.py:235",
    "ring_gru_cell_q": "src/repro/kernels/stream.py:417",
}

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15          # tensor cores: int8 multiply-adds
CUDA_CORE_OPS_PER_S = 67e12        # outside the tensor cores (fp32 rate)
DEVICE_TYPE = "cuda"               # where every path's outputs must lie


def say(*args) -> None:
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def artifact(name: str) -> pathlib.Path:
    return ASSETS / f"{name}.cortex-m4.int8.json"


def load_golden(name: str) -> dict:
    with np.load(ASSETS / f"{name}.cortex-m4.int8.golden.npz") as g:
        return {k: g[k] for k in g.files}


# ---------------------------------------------------------------------------
# Bounds: bytes moved once and operations done, from a kernel call's shapes.
# ---------------------------------------------------------------------------

def _segs(d: int) -> int:
    return -(-d // 128)


def _conv_taps(k, stride, padding, h_in, w_in, h_out, w_out) -> int:
    """In-bounds taps of a k x k conv over all output pixels."""
    from repro_torch.core.rowsched import conv_k2d_pad, conv_k2d_pad_w

    pv, ph = conv_k2d_pad(k, padding), conv_k2d_pad_w(k, padding)
    rows_ok = [sum(0 <= p * stride - pv + r < h_in for r in range(k))
               for p in range(h_out)]
    cols_ok = [sum(0 <= q * stride - ph + t < w_in for t in range(k))
               for q in range(w_out)]
    return sum(rows_ok) * sum(cols_ok)


def _conv_pixels_read(k, stride, padding, h_in, w_in, h_out, w_out) -> int:
    """Input pixels that some in-bounds tap of a k x k conv reads."""
    from repro_torch.core.rowsched import conv_k2d_pad, conv_k2d_pad_w

    pv, ph = conv_k2d_pad(k, padding), conv_k2d_pad_w(k, padding)
    rows = {p * stride - pv + r for p in range(h_out) for r in range(k)}
    cols = {q * stride - ph + t for q in range(w_out) for t in range(k)}
    return (len(rows & set(range(h_in))) * len(cols & set(range(w_in))))


def _pw_pixels_read(kw) -> int:
    """Input pixels a 1x1 conv reads (strided or resampled picks)."""
    from repro_torch.core.rowsched import resample_src

    def picks(n_in, n_out):
        if kw.get("resample"):
            return {resample_src(p, n_in, n_out) for p in range(n_out)}
        return {p * kw.get("stride", 1) for p in range(n_out)}
    return len(picks(kw["h_in"], kw["h_out"])) \
        * len(picks(kw["w_in"], kw["w_out"]))


def work(kernel: str, kw: dict) -> tuple[int, int, int]:
    """``(bytes, tensor_ops, core_ops)`` a kernel call must move and do.

    Bytes: every input pixel the op reads, once, at its data width (its
    live channels, not the whole 128-byte segments it sits in); every
    output row written once as whole segments (the kernels must store
    the channel tails as zeros); the streaming window read once and
    written back once at its data width; weights, biases and requant
    constants once.  Operations: 2 int8 ops per multiply-accumulate at
    in-bounds taps; elementwise integer ops (the pool's adds, the
    residual add's two requantizations and sum) counted apart, for the
    CUDA cores."""
    if kernel == "ring_avgpool_q":
        rows = kw["h"] * kw["w"]
        return rows * kw["c"] + _segs(kw["c"]) * 128, 0, rows * kw["c"]
    if kernel == "ring_add_q":
        rows, d = kw["rows"], kw["d"]
        return 2 * rows * d + rows * _segs(d) * 128, 0, 3 * rows * d
    if kernel == "ring_gemm_q":
        m, ci, co = kw["m_rows"], kw["d_in"], kw["d_out"]
        return (m * ci + m * _segs(co) * 128 + ci * co + 12 * co,
                2 * m * ci * co, 0)
    if kernel == "ring_gru_cell_q":
        ci, dh = kw["d_in"], kw["d_h"]
        g = 3 * dh
        # x and h read once; h' stored to the state and to the output.
        return (ci + dh + 2 * _segs(dh) * 128 + (ci + dh) * g + 20 * g,
                2 * (ci + dh) * g, 0)
    if kernel == "ring_conv_stream_q":
        ci, co, k = kw["c_in"], kw["c_out"], kw["k"]
        win = kw["h_win"] * kw["w_in"] * ci
        out = kw["h_out"] * kw["w_out"] * _segs(co) * 128
        taps = _conv_taps(k, kw["stride"], kw["padding"], kw["h_win"],
                          kw["w_in"], kw["h_out"], kw["w_out"])
        return 2 * win + out + k * k * ci * co + 12 * co, \
            2 * taps * ci * co, 0
    ci = kw["c"] if kernel == "ring_conv_dw_q" else kw["c_in"]
    co = kw["c"] if kernel == "ring_conv_dw_q" else kw["c_out"]
    out = kw["h_out"] * kw["w_out"] * _segs(co) * 128 + 12 * co
    if kernel == "ring_conv_pw_q":
        return (_pw_pixels_read(kw) * ci + out + ci * co,
                2 * kw["h_out"] * kw["w_out"] * ci * co, 0)
    k = kw["rs"] if kernel == "ring_conv_dw_q" else kw["k"]
    geom = (k, kw["stride"], kw["padding"], kw["h_in"], kw["w_in"],
            kw["h_out"], kw["w_out"])
    io = _conv_pixels_read(*geom) * ci + out
    taps = _conv_taps(*geom)
    if kernel == "ring_conv_dw_q":
        return io + k * k * ci, 2 * taps * ci, 0
    return io + k * k * ci * co, 2 * taps * ci * co, 0


def bound(kernel: str, kw: dict) -> tuple[float, str]:
    nbytes, tensor_ops, core_ops = work(kernel, kw)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = tensor_ops / INT8_OPS_PER_S + core_ops / CUDA_CORE_OPS_PER_S
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


def plan_cases(name: str, cn):
    """One case per op of a loaded plan, named after the plan."""
    from repro_torch.kernels.cases import program_cases

    return program_cases(cn.program, cn.qnet.qparams,
                         kernel_block_rows=cn.target.kernel_block_rows,
                         prefix=f"{name}_")


def phase_parity(cases) -> dict[str, int]:
    """Every case: kernel vs plain version on the card, bitwise; and the
    cases whose launch read its weights from global memory, as the
    wrapper decided (``<wrapper>.weights_staged``).  Returns the max
    |difference| per kernel (0, or this raises)."""
    from repro_torch.kernels import KERNELS, PLAIN
    from repro_torch.kernels.cases import case_inputs

    say(f"phase 2: {len(cases)} kernel calls against their plain versions "
        "on the card (bitwise)")
    err: dict[str, int] = {name: 0 for name in KERNELS}
    global_w = []
    for case in cases:
        pool, params = case_inputs(case, seed=0)
        want = torch.from_numpy(pool).cuda()
        PLAIN[case.kernel](want, *_cuda(params), **case.kwargs)
        got = torch.from_numpy(pool).cuda()
        KERNELS[case.kernel](got, *_cuda(params), **case.kwargs)
        if KERNELS[case.kernel].weights_staged is False:
            global_w.append(case.name)
        torch.cuda.synchronize()
        diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
        err[case.kernel] = max(err[case.kernel], int(diff.max()))
        if not torch.equal(got, want):
            seg = int(diff.amax(dim=1).nonzero()[0])
            raise SystemExit(f"{case.name}: {case.kernel} differs from its "
                             f"plain version, first at segment {seg}")
    say(f"  all {len(cases)} bitwise equal; kernels covered: "
        f"{sorted({c.kernel for c in cases})}")
    say(f"  weights read from global memory (too large for shared): "
        f"{global_w or 'none'}")
    return err


def _path_kernels(cn) -> set[str]:
    """The kernels a plan's ops launch."""
    from repro_torch.core.executors import op_kernel_call

    return {op_kernel_call(cn.program, op, p)[0]
            for op, p in zip(cn.program.ops, cn.qnet.qparams)}


def _counted(label: str, cn, drive) -> dict[str, int]:
    """Run ``drive()`` with the launch counts set to 0 just before and
    read just after; every kernel of the plan must have launched."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    drive()
    torch.cuda.synchronize()
    counts = launch_counts()
    missing = sorted(k for k in _path_kernels(cn) if not counts[k])
    if missing:
        raise SystemExit(f"{label}: kernels never launched: {missing}")
    say(f"  {label} launches: "
        f"{ {k: n for k, n in counts.items() if n} }")
    return counts


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def path_serve(name: str, cn, golden) -> dict[str, int]:
    """``run`` on the card: 8 inputs batched and 8 one by one, equal to
    the golden in float outputs, int8 outputs and final-pool sha256."""
    from repro_torch.compile.artifact import to_device
    from repro_torch.core.executors import run_program
    from repro_torch.quant.qtensor import QParams, quantize

    x = torch.from_numpy(golden["x"]).cuda()
    out = {}

    def drive():
        out["batch"] = cn.run(x)
        out["single"] = [cn.run(xi) for xi in x]

    counts = _counted(f"{name} run", cn, drive)
    want = torch.from_numpy(golden["y"]).cuda()
    if out["batch"].device.type != DEVICE_TYPE \
            or not torch.equal(out["batch"], want):
        raise SystemExit(f"{name}: batched float outputs differ from the "
                         "golden")
    for i, y in enumerate(out["single"]):
        if not torch.equal(y, want[i]):
            raise SystemExit(f"{name}: float output {i} differs from the "
                             "golden")
    qparams = to_device(cn.qnet.qparams, x.device)
    for i, xi in enumerate(x):
        xq = quantize(xi, QParams(scale=cn.qnet.in_scale))
        y_q, pool = run_program(cn.program, xq, qparams,
                                kernel_block_rows=cn.target.kernel_block_rows)
        if not np.array_equal(y_q.cpu().numpy(), golden["y_q"][i]):
            raise SystemExit(f"{name}: int8 output {i} differs from the "
                             "golden")
        if _sha(pool.array) != golden["pool_sha256"][i]:
            raise SystemExit(f"{name}: final pool {i} differs from the "
                             "golden")
    say(f"  {name}: {tuple(out['batch'].shape)} float outputs, int8 outputs "
        "and final-pool sha256 equal the golden on all 8")
    return counts


def path_stream(name: str, cn, golden) -> dict[str, int]:
    """``stream().step`` on the card for every golden frame: each step's
    int8 output and the last pool equal the golden; then float frames
    give the dequantized golden."""
    frames = torch.from_numpy(golden["x_q"]).cuda()
    session = cn.stream()
    ys = []
    counts = _counted(f"{name} stream", cn,
                      lambda: ys.extend(session.step(f) for f in frames))
    for i, y in enumerate(ys):
        if y.device.type != DEVICE_TYPE \
                or not np.array_equal(y.cpu().numpy(), golden["y_q"][i]):
            raise SystemExit(f"{name}: step {i} differs from the golden")
    if _sha(session.pool.array) != str(golden["pool_sha256"]):
        raise SystemExit(f"{name}: the pool after {len(ys)} steps differs "
                         "from the golden")
    session.reset()
    for i, f in enumerate(golden["x"][:8]):
        if not np.array_equal(session.step(f).cpu().numpy(),
                              golden["y"][i]):
            raise SystemExit(f"{name}: float step {i} differs from the "
                             "golden")
    say(f"  {name}: {len(ys)} steps, every int8 output and the final pool "
        f"equal the golden ({session.state_bytes} B of state)")
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
                  "ring_add_q": "add_kernel",
                  "ring_avgpool_q": "avgpool_kernel",
                  "ring_conv_stream_q": "conv_stream_kernel",
                  "ring_gru_cell_q": "gru_kernel"}


def _device_busy(fn, reps: int = 20):
    """From torch.profiler over ``reps`` calls of ``fn``: the device time
    of all kernels over the wall time (None when the profiler sees no
    device time), the wall time per call in us, and each ring kernel's
    mean device time per launch in ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
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


def time_cases(cases) -> dict[str, dict]:
    """Per kernel over ``cases`` (one per op of a plan): the mean device
    time per launch, host time with the launch, plain-version time and
    bound."""
    from repro_torch.kernels import KERNELS, PLAIN
    from repro_torch.kernels.cases import case_inputs

    out: dict[str, dict] = {}
    for name in KERNELS:
        ms, plain_ms, host_ms, bounds = [], [], [], []
        for case in (c for c in cases if c.kernel == name):
            pool, params = case_inputs(case, seed=0)
            pool, params = torch.from_numpy(pool).cuda(), _cuda(params)
            kern, plain = KERNELS[name], PLAIN[name]
            host_ms.append(_host_ms(
                lambda: kern(pool, *params, **case.kwargs), 20))
            ms.append(_held_ms(lambda: kern(pool, *params, **case.kwargs),
                               50))
            plain_ms.append(_event_ms(
                lambda: plain(pool, *params, **case.kwargs), 5))
            bounds.append(bound(name, case.kwargs))
        if ms:
            out[name] = {"ms": statistics.mean(ms),
                         "plain_ms": statistics.mean(plain_ms),
                         "host_ms": statistics.mean(host_ms),
                         "bound_ms": statistics.mean(b for b, _ in bounds),
                         "bound_by": bounds[0][1], "ops": len(ms)}
    return out


def phase_timing(served, streamed, cases, counts, errs):
    """Times every path and its kernels; returns the per-kernel rows of
    the ``{"kernels": [...]}`` line and the per-path latency and busy
    share."""
    from repro_torch.kernels import KERNELS

    say("phase 4: timing")
    by_path = {}
    for label, cn, drive, per in served + streamed:
        t = time_cases(cases[label])
        busy, call_us, prof_ms = _device_busy(drive)
        lat = _host_ms(drive, 30)
        busy_txt = "not measured" if busy is None else f"{busy:.4f}"
        say(f"  {label}: {lat:.4f} ms per {per} (host clock, ending in "
            f"synchronize); device busy {busy_txt} of {call_us:.1f} us per "
            f"{per} (profiler)")
        if per == "inference":
            x = torch.from_numpy(load_golden(label)["x"]).cuda()
            b8 = _host_ms(lambda: cn.run(x), 10) / len(x)
            say(f"  {label}: {b8:.4f} ms per inference at batch {len(x)}")
        for name, row in t.items():
            row["profiler_ms"] = prof_ms.get(name)
            row["launches"] = counts[label][name]
            say(f"    {name:18s} {row['ms'] * 1e3:9.2f} us/launch (device, "
                f"mean of {row['ops']} ops), {row['host_ms'] * 1e3:8.2f} us "
                f"with launch (host), plain {row['plain_ms'] * 1e3:9.2f} "
                f"us, bound {row['bound_ms'] * 1e3:.4f} us "
                f"({row['bound_by']}), {row['launches']} launches")
        by_path[label] = {"latency_ms": lat, "device_busy": busy,
                          "kernels": t}
    rows = []
    for name in KERNELS:
        per = {p: v["kernels"][name] for p, v in by_path.items()
               if name in v["kernels"]}
        weight = {p: r["ops"] for p, r in per.items()}
        n = sum(weight.values())

        def avg(key):
            return sum(r[key] * weight[p] for p, r in per.items()) / n
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": sum(c[name] for c in counts.values()),
            "max_abs_err": errs[name], "ms": avg("ms"),
            "plain_ms": avg("plain_ms"), "bound_ms": avg("bound_ms"),
            "bound_by": next(iter(per.values()))["bound_by"],
            "library_ms": None, "host_ms": avg("host_ms"),
            "by_path": per})
    return rows, {p: {k: v for k, v in d.items() if k != "kernels"}
                  for p, d in by_path.items()}


def main() -> None:
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit("chip_smoke.py runs from the root of a checkout "
                         "that holds src/repro_torch")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; none is "
                         "available")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    from repro_torch.kernels.cases import EDGE_CASES

    card = nvidia_smi_line()
    say(f"phase 0: card {card}")
    say(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")
    phase_build()

    plans = {n: repro_torch.load(artifact(n)) for n in NETS + STREAMS}
    goldens = {n: load_golden(n) for n in NETS + STREAMS}
    cases = {n: plan_cases(n, cn) for n, cn in plans.items()}
    errs = phase_parity(EDGE_CASES + sum(cases.values(), ()))

    say("phase 3: the paths on the card")
    counts = {}
    for n in NETS:
        counts[n] = path_serve(n, plans[n], goldens[n])
    for n in STREAMS:
        counts[n] = path_stream(n, plans[n], goldens[n])

    served = []
    for n in NETS:
        x1 = torch.from_numpy(goldens[n]["x"][0]).cuda()
        served.append((n, plans[n],
                       lambda cn=plans[n], x1=x1: cn.run(x1), "inference"))
    streamed = []
    for n in STREAMS:
        session = plans[n].stream()
        frame = torch.from_numpy(goldens[n]["x_q"][0]).cuda()
        streamed.append((n, plans[n],
                         lambda s=session, f=frame: s.step(f), "step"))
    rows, paths = phase_timing(served, streamed, cases, counts, errs)

    say(json.dumps({"paths": paths}))
    say(json.dumps({"kernels": rows}))
    say(nvidia_smi_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
