"""The port's executor registry (``repro_torch.core``: ``execute``,
``executor_names``, ``register_executor``), as the reference's
``tests/test_program.py::test_executor_registry_is_pluggable`` holds
its own: a plan runs on a named backend (``"cuda"``, ``"cpu"``,
``"sim"`` or one registered), ``None`` picks the pool's device, and a
named array backend refuses a pool on another device instead of falling
back to it."""
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import core, load
from repro_torch.compile.artifact import to_device
from repro_torch.core import execute, executor_names, register_executor
from repro_torch.core import executors
from repro_torch.core.program import GemmSpec, plan_module_program, \
    plan_program
from repro_torch.core.vpool import VirtualPool
from repro_torch.kernels.cases import int8_stem
from repro_torch.quant.qtensor import QParams, quantize

ASSETS = (pathlib.Path(__file__).resolve().parents[1] / "src"
          / "repro_torch" / "assets")


def _gemm_program():
    program = plan_program(6, 48, [GemmSpec(64, "gelu"), GemmSpec(32)],
                           block_rows=2)
    rng = np.random.default_rng(0)
    params = [(torch.from_numpy(rng.standard_normal((48, 64),
                                                    np.float32) / 7), None),
              (torch.from_numpy(rng.standard_normal((64, 32),
                                                    np.float32) / 8), None)]
    x = torch.from_numpy(rng.standard_normal((6, 48), np.float32))
    return program, params, x


def _staged(program, x, device="cpu"):
    pool = VirtualPool.alloc(program.spec(), device)
    pool.stage_rows(x.to(device), program.input_ptr)
    return pool


def test_the_registry_is_exported_by_core():
    assert (core.execute, core.executor_names, core.register_executor) == \
        (executors.execute, executors.executor_names,
         executors.register_executor)


def test_the_registry_is_pluggable():
    program, params, x = _gemm_program()
    assert set(executor_names()) >= {"cuda", "cpu", "sim"}
    with pytest.raises(ValueError, match="unknown backend 'nope'; "
                       r"registered: \('cpu', 'cuda', 'sim'"):
        execute(program, _staged(program, x), params, backend="nope")

    @register_executor("_counting")
    def _count(program, pool, params, **kw):
        return len(program.ops), kw

    try:
        assert "_counting" in executor_names()
        assert execute(program, backend="_counting", tracer=None) == \
            (2, {"tracer": None})
    finally:
        del executors._EXECUTORS["_counting"]
    assert "_counting" not in executor_names()


def test_cpu_is_what_the_cpu_pool_picks():
    """fp32 and int8 (the DS-CNN asset, against its golden)."""
    program, params, x = _gemm_program()
    named = execute(program, _staged(program, x), params, backend="cpu")
    picked = execute(program, _staged(program, x), params)
    assert torch.equal(named.array, picked.array)
    cn = load(ASSETS / f"{int8_stem('ds-cnn')}.json")
    g = np.load(ASSETS / f"{int8_stem('ds-cnn')}.golden.npz")
    xq = quantize(torch.from_numpy(g["x"][0]),
                  QParams(scale=cn.qnet.in_scale))
    qparams = to_device(cn.qnet.qparams, "cpu")
    pools = [execute(cn.program, _staged(cn.program, xq), qparams,
                     backend=b, kernel_block_rows=cn.target.kernel_block_rows)
             for b in ("cpu", None)]
    assert torch.equal(pools[0].array, pools[1].array)
    y = pools[0].fetch_rows(cn.program.output_ptr, cn.program.out_rows,
                            cn.program.out_dim)
    assert np.array_equal(y.numpy(), g["y_q"][0])


def test_the_named_device_backends_refuse_another_device():
    """Nothing falls back: ``"cuda"`` on a CPU pool raises before any op,
    and so does ``"cpu"`` on a pool elsewhere (here the meta device,
    which no backend runs)."""
    program, params, x = _gemm_program()
    pool = _staged(program, x)
    before = pool.array.clone()
    with pytest.raises(ValueError, match="the 'cuda' backend runs a pool "
                       "on its device, not on cpu"):
        execute(program, pool, params, backend="cuda")
    assert torch.equal(pool.array, before)
    meta = torch.empty(tuple(pool.array.shape), device="meta")
    with pytest.raises(ValueError, match="the 'cpu' backend runs a pool on "
                       "its device, not on meta"):
        execute(program, meta, params, backend="cpu")
    with pytest.raises(ValueError, match="no ring executor for device meta"):
        execute(program, meta, params)


def test_sim_is_the_clobber_oracle():
    """``"sim"`` ignores the pool and params and returns the oracle's
    pool, as ``run_program_sim`` does."""
    program, params, x = _gemm_program()
    sim = execute(program, backend="sim")
    want = executors.run_program_sim(program)
    assert (sim.reads, sim.writes, sim.frees, sim.peak_live) == \
        (want.reads, want.writes, want.frees, want.peak_live)
    assert sim.reads > 0


def test_a_plan_only_program_runs_on_no_backend():
    from repro_torch.core.graph_planner import MCUNET_5FPS_VWW

    prog = plan_module_program(MCUNET_5FPS_VWW[0])
    assert not prog.executable
    for backend in ("sim", "cpu"):
        with pytest.raises(NotImplementedError, match="plan-only"):
            execute(prog, backend=backend)
