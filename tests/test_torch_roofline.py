"""The ring roofline (``repro_torch.roofline``) held against the
reference's ``repro.roofline.analysis.ring_traffic_summary`` on the CPU:
the same per-kind and whole-program terms from the same trace, on every
committed plan and on a trace measured on the CPU."""
import pathlib

import numpy as np
import pytest

import repro_torch
from repro.core import execute as ref_execute
from repro.core.program import PoolProgram as RefPoolProgram
from repro.obs import RingTracer as RefRingTracer
from repro.obs import build_trace as ref_build_trace
from repro.roofline.analysis import MCU_PEAK_MACS as REF_PEAK
from repro.roofline.analysis import MCU_SRAM_BW as REF_BW
from repro.roofline.analysis import \
    ring_traffic_summary as ref_ring_traffic_summary
from repro_torch.compile import artifact
from repro_torch.core.executors import run_program_sim
from repro_torch.core.program import PoolProgram
from repro_torch.obs import RingTracer, build_trace
from repro_torch.roofline import (MCU_PEAK_MACS, MCU_SRAM_BW,
                                  ring_traffic_summary)

ASSETS = pathlib.Path(artifact.__file__).parents[1] / "assets"
PLANS = sorted(p.name for p in ASSETS.glob("*.json"))


def test_the_machine_balance_is_the_references():
    assert (MCU_PEAK_MACS, MCU_SRAM_BW) == (REF_PEAK, REF_BW)


@pytest.mark.parametrize("name", PLANS)
def test_the_summary_is_the_references(name):
    payload = artifact.load(ASSETS / name)
    prog = PoolProgram.from_json_dict(payload["program"])
    tracer = RingTracer()
    run_program_sim(prog, tracer=tracer)
    art = build_trace(prog, tracer=tracer, net=payload["net"])
    have = ring_traffic_summary(art)
    assert have == ring_traffic_summary(art.to_dict())
    assert have == ref_ring_traffic_summary(art.to_dict())
    ref_tracer = RefRingTracer()
    ref_prog = RefPoolProgram.from_json_dict(payload["program"])
    ref_execute(ref_prog, backend="sim", tracer=ref_tracer)
    assert have == ref_ring_traffic_summary(
        ref_build_trace(ref_prog, tracer=ref_tracer, net=payload["net"]))
    # the staged input and the fetched output are kinds of their own
    assert {"stage", "fetch"} <= set(have["kinds"])
    assert have["bytes_moved"] == sum(k["bytes_moved"]
                                      for k in have["kinds"].values())
    for k in have["kinds"].values():
        assert k["bound"] == ("compute" if k["t_compute_s"]
                              >= k["t_memory_s"] else "memory")


@pytest.mark.parametrize("peak,bw", [(80e6, 320e6), (480e6, 1.92e9),
                                     (1e9, 1e6)])
def test_the_summary_of_a_cpu_trace_at_other_balances(peak, bw):
    cn = repro_torch.load(ASSETS / "resnet-8.cortex-m4.int8.json")
    with np.load(ASSETS / "resnet-8.cortex-m4.int8.golden.npz") as g:
        _, art = cn.run(g["x"][0], device="cpu", trace=True)
    kw = dict(peak_macs_per_s=peak, sram_bw_bytes_per_s=bw)
    have = ring_traffic_summary(art, **kw)
    assert have == ref_ring_traffic_summary(art.to_dict(), **kw)
    assert have["backend"] == "cpu" and have["net"] == "resnet-8"
    assert set(have["kinds"]) == {"stage", "conv_k2d", "add", "conv_pw",
                                  "pool_avg", "gemm", "fetch"}
    assert have["ridge_intensity"] == peak / bw
    assert have["watermark_bytes"] == cn.program.pool_bytes
