"""The port's sim oracle held against the reference's: the circular
segment pool (``core/pool.py``), ``run_program_sim`` (the clobber oracle
``compile`` certifies with) and the ``sim`` backend of
``StreamSession``.

The oracle is plain Python over integers, so it must agree with the
reference exactly: the same counters (reads, writes, frees, peak and
final live segments) on every zoo plan, and the same verdict — and the
same first clobber — on every mutant of a solved plan that the
reference's own mutator (``repro.analysis.mutate``) makes.
"""
import json
import pathlib
import tempfile

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro
import repro_torch
from repro.analysis.mutate import mutations
from repro.core import pool as ref_pool
from repro.core.executors import run_program_sim as ref_sim
from repro_torch.compile import artifact
from repro_torch.core import pool
from repro_torch.core.executors import run_program_sim
from repro_torch.core.program import PoolProgram

TARGETS = ("cortex-m4", "cortex-m7", "host-sim")
ASSETS = pathlib.Path(artifact.__file__).parents[1] / "assets"


def _port(program) -> PoolProgram:
    return PoolProgram.from_json_dict(program.to_json_dict())


def _counters(sim) -> tuple:
    return sim.reads, sim.writes, sim.frees, sim.peak_live, sim.live


def _verdict(sim_fn, program, clobber):
    """``("ok", counters)`` or ``("clobber", message)`` of one run."""
    try:
        return "ok", _counters(sim_fn(program))
    except clobber as e:
        return "clobber", str(e)


@pytest.fixture(scope="module")
def zoo():
    """The reference's plan-only programs of every registered net on each
    target (no gate, so the over-budget one is here too) and the DS-CNN
    streaming form."""
    progs = {}
    for net in repro.available_nets():
        for t in TARGETS:
            progs[f"{net}@{t}"] = repro.compile(
                net, t, quantize=False, lint=False, certify=False,
                check_budget=False).program
    progs["ds-cnn-streaming@cortex-m4"] = repro.compile(
        "ds-cnn", "cortex-m4", streaming=True, quantize=False, lint=False,
        certify=False).program
    return progs


# ---------------------------------------------------------------------------
# SegmentPool.
# ---------------------------------------------------------------------------

_OPS = st.lists(st.tuples(st.sampled_from(["write", "read", "free"]),
                          st.integers(0, 11), st.integers(0, 2)),
                min_size=1, max_size=40)


@settings(derandomize=True, database=None, max_examples=120, deadline=None)
@given(n=st.integers(1, 8), ops=_OPS)
def test_segment_pool_replays_as_the_reference(n, ops):
    """A random write/read/free sequence: the same counters after every
    operation and the same first error."""
    have, want = pool.SegmentPool(n, 4), ref_pool.SegmentPool(n, 4)
    for kind, addr, owner in ops:
        res = []
        for p, err in ((have, pool.PoolClobberError),
                       (want, ref_pool.PoolClobberError)):
            try:
                getattr(p, kind)(addr, owner=owner)
                res.append(None)
            except err as e:
                res.append(str(e))
        assert res[0] == res[1]
        assert _counters(have) == _counters(want)
        assert have.peak_bytes == want.peak_bytes
        if res[0] is not None:
            break


@pytest.mark.parametrize("M,N,K,slack", [(2, 2, 3, 0), (4, 3, 5, 0),
                                         (3, 5, 2, 0), (4, 3, 5, 1)])
def test_gemm_schedule_replays_as_the_reference(M, N, K, slack):
    """The paper's Fig.-4 FC schedule at the solved offset runs clean (and
    its outputs survive); one segment less clobbers in both."""
    from repro_torch.core.planner import gemm_offset_closed_form

    delta = gemm_offset_closed_form(M, N, K) - slack
    size = max(M * N, M * K + delta) - min(0, delta)
    res = []
    for mod in (pool, ref_pool):
        p = mod.SegmentPool(size, 1)
        payload = np.arange(M * K).reshape(M, K)
        try:
            out = mod.run_gemm_schedule(p, M, N, K, 0, delta, payload)
            res.append((sorted(out.items()), _counters(p)))
        except mod.PoolClobberError as e:
            res.append(str(e))
    assert res[0] == res[1]
    assert isinstance(res[0], str) == bool(slack)


# ---------------------------------------------------------------------------
# run_program_sim.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("target", TARGETS)
def test_sim_counters_equal_the_reference_on_every_zoo_plan(zoo, target):
    n = 0
    for key, prog in zoo.items():
        if not key.endswith(f"@{target}"):
            continue
        have = run_program_sim(_port(prog))
        want = ref_sim(prog)
        assert _counters(have) == _counters(want), key
        assert have.n == want.n == prog.n_segments
        n += 1
    assert n >= 7


def test_sim_carries_stream_state_as_the_reference(zoo):
    """A persistent pool: every step replays against the state the last
    one left, with the same counters each time."""
    prog = zoo["ds-cnn-streaming@cortex-m4"]
    have, want = None, None
    for _ in range(3):
        have = run_program_sim(_port(prog), pool=have)
        want = ref_sim(prog, pool=want)
        last = prog.ops[-1]
        for p in (have, want):
            for j in range(last.out_segments):
                p.free(last.out_ptr + j, owner=(len(prog.ops), j))
        assert _counters(have) == _counters(want)


def _mutant_cases():
    return [("ds-cnn", "cortex-m4", {}, 1), ("resnet-8", "cortex-m4", {}, 2),
            ("ad-toyadmos", "host-sim", {}, 1),
            ("ds-cnn", "cortex-m4", {"streaming": True}, 2),
            ("mcunet-5fps-vww", "cortex-m4", {}, 4)]


@pytest.mark.parametrize("net,target,kw,stride", _mutant_cases(),
                         ids=lambda v: str(v))
def test_every_mutant_gets_the_reference_verdict(net, target, kw, stride):
    """The reference's mutator corrupts one solved quantity at a time
    (in/out/aux offsets moved onto live segments, hold flags flipped,
    chains rewired, the ring shrunk): the port's oracle raises
    ``PoolClobberError`` with the same message exactly where the
    reference's does, and counts the same where it does not."""
    prog = repro.compile(net, target, quantize=False, lint=False,
                         certify=False, **kw).program
    n_clobber = n_ok = 0
    for m in mutations(prog, ops_stride=stride):
        have = _verdict(lambda p: run_program_sim(_port(p)), m.program,
                        pool.PoolClobberError)
        want = _verdict(ref_sim, m.program, ref_pool.PoolClobberError)
        assert have == want, m.tag
        n_clobber += have[0] == "clobber"
        n_ok += have[0] == "ok"
    assert n_clobber > 5 and n_ok > 0


@pytest.mark.parametrize("net", ["ds-cnn", "resnet-8", "mcunet-5fps-vww"])
def test_an_output_moved_onto_a_live_segment_clobbers_in_both(net):
    """One solved offset moved one segment onto a live one — the
    canonical broken plan — raises in the port as in the reference."""
    from repro.analysis.mutate import break_plan

    prog = repro.compile(net, "cortex-m4", quantize=False, lint=False,
                         certify=False).program
    broken = break_plan(prog)
    with pytest.raises(ref_pool.PoolClobberError) as want:
        ref_sim(broken.program)
    with pytest.raises(pool.PoolClobberError) as have:
        run_program_sim(_port(broken.program))
    assert str(have.value) == str(want.value)


def test_delta_slack_plans_clobber_in_both():
    """``delta_slack=1`` shrinks every solved delta: both oracles refuse
    the plan with the same first clobber (the plans are exact optima)."""
    from repro.core.program import ConvK2DSpec as RK, plan_program as rplan
    from repro_torch.core.program import ConvK2DSpec as K, plan_program

    have = plan_program(64, 8, [K(8, 8, 8, 24), K(8, 8, 24, 8, stride=2)],
                        delta_slack=1)
    want = rplan(64, 8, [RK(8, 8, 8, 24), RK(8, 8, 24, 8, stride=2)],
                 delta_slack=1)
    assert have.to_json_dict() == want.to_json_dict()
    assert _verdict(run_program_sim, have, pool.PoolClobberError) \
        == _verdict(ref_sim, want, ref_pool.PoolClobberError)
    assert _verdict(run_program_sim, have, pool.PoolClobberError)[0] \
        == "clobber"


# ---------------------------------------------------------------------------
# StreamSession(backend="sim").
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ds-cnn-stream.cortex-m4.int8",
                                  "kws-gru-chain.cortex-m4.int8",
                                  "ds-cnn-stream.host-sim.float32"])
def test_sim_stream_steps_count_as_the_reference(name):
    """The sim backend needs no device and no frame: each step returns
    the oracle's counters, the reference's at every step."""
    path = ASSETS / f"{name}.json"
    have = repro_torch.load(path).stream(backend="sim")
    payload = artifact.load(path)
    payload.setdefault("params", None)
    with tempfile.NamedTemporaryFile("w", suffix=".json") as f:
        json.dump(payload, f)
        f.flush()
        want = repro.load(f.name).stream(backend="sim")
    for _ in range(4):
        assert have.step() == want.step()
    assert have.state_bytes == want.state_bytes
    have.reset()
    assert have.steps == 0 and have.pool is None
    assert have.step()["steps"] == 1
