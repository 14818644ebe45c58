"""The port's planner held against the reference's: the affine access
model (``core/affine.py``), the Eq.-(1) solver (``core/planner.py``),
the Eq.-(2) fused plans and module baselines (``core/graph_planner.py``,
``core/baselines.py``), the row schedules (``core/rowsched.py``) and the
planning half of ``core/program.py``.

Every comparison is exact: the port's copies are plain Python and numpy,
so every solved offset, footprint and schedule must equal the
reference's.  Property tests draw with ``derandomize=True`` and no
example database, so no saved draw replays into them.
"""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro
from repro.core import affine as ref_affine
from repro.core import baselines as ref_baselines
from repro.core import graph_planner as ref_gp
from repro.core import planner as ref_planner
from repro.core import program as ref_program
from repro.core import rowsched as ref_rowsched
from repro_torch.core import affine, baselines, graph_planner as gp
from repro_torch.core import planner, program, rowsched

PROPERTY = settings(derandomize=True, database=None, max_examples=60,
                    deadline=None)
TARGETS = ("cortex-m4", "cortex-m7", "host-sim")


def _port(spec):
    """The port's twin of a reference layer spec."""
    fields = {f.name: getattr(spec, f.name)
              for f in dataclasses.fields(spec)}
    if "cfg" in fields:
        fields["cfg"] = gp.ModuleConfig(**dataclasses.asdict(fields["cfg"]))
    return getattr(program, type(spec).__name__)(**fields)


# ---------------------------------------------------------------------------
# affine + planner (Eq. 1).
# ---------------------------------------------------------------------------

@PROPERTY
@given(M=st.integers(1, 6), N=st.integers(1, 6), K=st.integers(1, 6))
def test_gemm_offsets_and_footprints_equal_the_reference(M, N, K):
    assert planner.gemm_offset_closed_form(M, N, K) \
        == ref_planner.gemm_offset_closed_form(M, N, K)
    assert planner.gemm_min_footprint_segments(M, N, K) \
        == ref_planner.gemm_min_footprint_segments(M, N, K)
    have = planner.plan_gemm(M, N, K, segment_bytes=4, validate=True)
    want = ref_planner.plan_gemm(M, N, K, segment_bytes=4, validate=True)
    assert dataclasses.asdict(have) == dataclasses.asdict(want)
    assert (have.pool_segments, have.naive_segments, have.saving_fraction) \
        == (want.pool_segments, want.naive_segments, want.saving_fraction)
    dom = affine.gemm_domain(M, N, K)
    rd, wr = affine.gemm_read_access(M, K), affine.gemm_write_access(M, N)
    scan = planner.solve_offset_scan(dom, rd, wr)
    assert scan == ref_planner.solve_offset_scan(
        ref_affine.gemm_domain(M, N, K), ref_affine.gemm_read_access(M, K),
        ref_affine.gemm_write_access(M, N))
    assert scan == planner.solve_offset_bruteforce(dom, rd, wr)


@PROPERTY
@given(H=st.integers(1, 7), W=st.integers(1, 7), C=st.integers(1, 9),
       K=st.integers(1, 9), stride=st.integers(1, 3),
       eb=st.sampled_from([1, 2, 4]))
def test_pointwise_conv_plans_equal_the_reference(H, W, C, K, stride, eb):
    have = planner.plan_pointwise_conv(H, W, C, K, stride=stride,
                                       elem_bytes=eb)
    want = ref_planner.plan_pointwise_conv(H, W, C, K, stride=stride,
                                           elem_bytes=eb)
    assert dataclasses.asdict(have) == dataclasses.asdict(want)


@pytest.mark.parametrize("P,Q,K,C,stride,r,s", [
    (3, 4, 2, 5, 1, 0, 0), (2, 2, 3, 1, 2, 1, 1), (4, 1, 1, 3, 1, 0, 2)])
def test_conv_access_functions_equal_the_reference(P, Q, K, C, stride, r, s):
    dom, ref_dom = (affine.conv2d_pointwise_domain(P, Q, K, C),
                    ref_affine.conv2d_pointwise_domain(P, Q, K, C))
    assert dom.extents == ref_dom.extents and dom.size == ref_dom.size
    np.testing.assert_array_equal(dom.points_lex(), ref_dom.points_lex())
    H, W = P * stride + r, Q * stride + s
    for have, want in (
            (affine.conv2d_read_access(H, W, C, stride=stride, r=r, s=s),
             ref_affine.conv2d_read_access(H, W, C, stride=stride, r=r,
                                           s=s)),
            (affine.conv2d_write_access(P, Q, K),
             ref_affine.conv2d_write_access(P, Q, K))):
        assert (have.A, have.V, have.shape, have.L, have.size) \
            == (want.A, want.V, want.shape, want.L, want.size)
        c, c0 = have.linear_coeffs()
        wc, wc0 = want.linear_coeffs()
        np.testing.assert_array_equal(c, wc)
        assert c0 == wc0
        np.testing.assert_array_equal(have.addresses(dom.points_lex()),
                                      want.addresses(ref_dom.points_lex()))
    assert planner.motivational_example() \
        == ref_planner.motivational_example() == (7, 10)


def test_affine_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError, match="empty"):
        affine.IterDomain((2, 0))
    with pytest.raises(ValueError, match="rank"):
        affine.AccessFn(A=((1,),), V=(0, 0), shape=(2,))


# ---------------------------------------------------------------------------
# graph_planner (Eq. 2) + baselines.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("table", ["MCUNET_5FPS_VWW",
                                   "MCUNET_320KB_IMAGENET"])
def test_mcunet_tables_and_module_plans_equal_the_reference(table):
    have, want = getattr(gp, table), getattr(ref_gp, table)
    assert [dataclasses.asdict(c) for c in have] \
        == [dataclasses.asdict(c) for c in want]
    for cfg, rcfg in zip(have, want):
        assert cfg.spatial() == rcfg.spatial()
        assert (cfg.has_residual, cfg.input_bytes, cfg.output_bytes) \
            == (rcfg.has_residual, rcfg.input_bytes, rcfg.output_bytes)
        for ws in ("paper_11seg", "row_cache"):
            assert dataclasses.asdict(gp.plan_inverted_bottleneck(cfg, ws)) \
                == dataclasses.asdict(ref_gp.plan_inverted_bottleneck(
                    rcfg, ws))
        assert gp.vmcu_module_bytes(cfg) == ref_gp.vmcu_module_bytes(rcfg)
        assert gp.tinyengine_module_bytes(cfg) \
            == ref_gp.tinyengine_module_bytes(rcfg)
        assert gp.hmcos_module_bytes(cfg) == ref_gp.hmcos_module_bytes(rcfg)
        assert gp.plan_module_fallback(cfg) \
            == ref_gp.plan_module_fallback(rcfg)


@PROPERTY
@given(hw=st.integers(2, 8), cin=st.integers(1, 12),
       cmid=st.integers(1, 16), cout=st.integers(1, 12),
       s1=st.sampled_from([1, 2]))
def test_module_bytes_equal_the_reference(hw, cin, cmid, cout, s1):
    """Equality, not the reference's own claim that a fused plan is never
    worse than the tensor-level one (which has a counterexample)."""
    cfg = gp.ModuleConfig("x", hw, cin, cmid, cout, 3, (s1, 1, 1))
    rcfg = ref_gp.ModuleConfig("x", hw, cin, cmid, cout, 3, (s1, 1, 1))
    assert gp.vmcu_module_bytes(cfg) == ref_gp.vmcu_module_bytes(rcfg)
    assert gp.tinyengine_module_bytes(cfg) \
        == ref_gp.tinyengine_module_bytes(rcfg)
    assert gp.hmcos_module_bytes(cfg) == ref_gp.hmcos_module_bytes(rcfg)


def test_the_reference_counterexample_is_reproduced():
    """``hw=4, cin=9, cmid=8, cout=1, s1=2``: the fused plan takes 228 B
    against the tensor-level 176 B, in the port as in the reference."""
    cfg = gp.ModuleConfig("x", 4, 9, 8, 1, 3, (2, 1, 1))
    rcfg = ref_gp.ModuleConfig("x", 4, 9, 8, 1, 3, (2, 1, 1))
    have = (gp.vmcu_module_bytes(cfg), gp.tinyengine_module_bytes(cfg))
    assert have == (ref_gp.vmcu_module_bytes(rcfg),
                    ref_gp.tinyengine_module_bytes(rcfg)) == (228, 176)


@PROPERTY
@given(M=st.integers(1, 6),
       dims=st.lists(st.integers(1, 40), min_size=2, max_size=5),
       eb=st.sampled_from([1, 2, 4]), rps=st.sampled_from([1, 2]))
def test_fc_chain_plans_equal_the_reference(M, dims, eb, rps):
    have = gp.plan_fc_chain(M, dims, elem_bytes=eb, rows_per_step=rps)
    want = ref_gp.plan_fc_chain(M, dims, elem_bytes=eb, rows_per_step=rps)
    assert dataclasses.asdict(have) == dataclasses.asdict(want)
    assert have.pool_bytes == want.pool_bytes


@PROPERTY
@given(w=st.lists(st.integers(0, 50), min_size=1, max_size=12),
       r=st.lists(st.integers(0, 50), min_size=1, max_size=12))
def test_stream_offset_equals_the_reference(w, r):
    n = min(len(w), len(r))
    we, rs = np.asarray(w[:n], np.int64), np.asarray(r[:n], np.int64)
    assert gp.solve_stream_offset(we, rs) \
        == ref_gp.solve_stream_offset(we, rs)


@pytest.mark.parametrize("im2col", [False, True])
def test_layer_baselines_equal_the_reference(im2col):
    """The paper's Fig.-7 pointwise cases at byte granularity."""
    assert baselines.FIG7_CASES == ref_baselines.FIG7_CASES
    for h, c, k in baselines.FIG7_CASES:
        have = baselines.pointwise_conv_layer(h, c, k, im2col=im2col)
        want = ref_baselines.pointwise_conv_layer(h, c, k, im2col=im2col)
        assert dataclasses.asdict(have) == dataclasses.asdict(want)
        assert baselines.tinyengine_bytes(have) \
            == ref_baselines.tinyengine_bytes(want)
        assert baselines.hmcos_bytes(have) == ref_baselines.hmcos_bytes(want)
        dw = dataclasses.replace(have, inplace_legal=True)
        rdw = dataclasses.replace(want, inplace_legal=True)
        assert baselines.tinyengine_bytes(dw) \
            == ref_baselines.tinyengine_bytes(rdw)


# ---------------------------------------------------------------------------
# rowsched + plan_program.
# ---------------------------------------------------------------------------

def _sched_equal(have, want):
    assert dataclasses.asdict(have) == dataclasses.asdict(want)
    np.testing.assert_array_equal(have.last_read(), want.last_read())
    np.testing.assert_array_equal(have.needed_min(), want.needed_min())
    assert have.frees() == want.frees()
    assert have.solve_delta() == want.solve_delta()


@pytest.fixture(scope="module")
def zoo_programs():
    """Every registered net's plan-only reference program on each
    target, and the two streaming forms."""
    progs = {}
    for net in repro.available_nets():
        for t in TARGETS:
            progs[(net, t)] = repro.compile(
                net, t, quantize=False, lint=False, certify=False,
                check_budget=False).program
    progs[("ds-cnn", "streaming")] = repro.compile(
        "ds-cnn", "cortex-m4", streaming=True, quantize=False, lint=False,
        certify=False).program
    return progs


@pytest.mark.parametrize("target", TARGETS)
def test_every_zoo_op_schedule_equals_the_reference(zoo_programs, target):
    n = 0
    for (net, t), prog in zoo_programs.items():
        if t not in (target, "streaming"):
            continue
        port = program.PoolProgram.from_json_dict(prog.to_json_dict())
        for op, rop in zip(port.ops, prog.ops):
            _sched_equal(rowsched.schedule_for_op(op, port.seg_width,
                                                  port.m_rows),
                         ref_rowsched.schedule_for_op(rop, prog.seg_width,
                                                      prog.m_rows))
            n += 1
    assert n > 100


@pytest.mark.parametrize("block", [1, 2, 4])
def test_coalesced_schedules_equal_the_reference(block):
    have = rowsched.conv_k2d_schedule(8, 8, 3, 3, k=3, stride=1,
                                      padding="same").coalesced(block)
    want = ref_rowsched.conv_k2d_schedule(8, 8, 3, 3, k=3, stride=1,
                                          padding="same").coalesced(block)
    _sched_equal(have, want)


@pytest.mark.parametrize("name,args,kwargs", [
    ("conv_pw_schedule", (8, 4, 2, 3), {"stride": 2}),
    ("conv_pw_schedule", (7, 3, 2, 3), {"resample": True}),
    ("conv_dw_schedule", (9, 5, 4, 4), {"rs": 5, "stride": 2}),
    ("conv_k2d_schedule", (10, 5, 2, 6), {"k": 3, "stride": 2,
                                          "padding": "valid"}),
    ("conv_k2d_schedule", (6, 3, 2, 6), {"k": 4, "stride": 2,
                                         "padding": "same_mid"}),
    ("ib_fused_schedule", (6, 6, 6), {"rs": 3, "residual": True}),
    ("add_schedule", (9, 2), {}),
    ("avgpool_schedule", (5, 10, 2), {}),
    ("conv_stream_schedule", (1, 25, 10, 5), {}),
    ("gru_cell_schedule", (1, 2), {}),
    ("gemm_fine_schedule", (3, 2, 4), {}),
    ("rowwise_schedule", (5, 3), {}),
])
def test_each_schedule_kind_equals_the_reference(name, args, kwargs):
    _sched_equal(getattr(rowsched, name)(*args, **kwargs),
                 getattr(ref_rowsched, name)(*args, **kwargs))


@pytest.mark.parametrize("k,padding", [(3, "same"), (3, "valid"),
                                       (5, "same_top"), (4, "same_mid")])
def test_conv_padding_helpers_equal_the_reference(k, padding):
    assert rowsched.conv_k2d_pad(k, padding) \
        == ref_rowsched.conv_k2d_pad(k, padding)
    assert rowsched.conv_k2d_pad_w(k, padding) \
        == ref_rowsched.conv_k2d_pad_w(k, padding)
    for h in range(k, k + 6):
        for s in (1, 2):
            assert rowsched.conv_k2d_out(h, k, s, padding) \
                == ref_rowsched.conv_k2d_out(h, k, s, padding)


def _layers():
    """Layer sequences covering every executable spec kind."""
    cfg = ref_gp.ModuleConfig("ib", 6, 16, 48, 16, 3, (1, 1, 1))
    return {
        "gemm_mlp": (4, 96, [ref_program.GemmSpec(200, "relu"),
                             ref_program.FusedMLPSpec(256, ff_tile=128),
                             ref_program.ElementwiseSpec("silu"),
                             ref_program.GemmSpec(40)]),
        "convs": (64, 8, [ref_program.ConvK2DSpec(8, 8, 8, 24, k=3),
                          ref_program.ConvDWSpec(8, 8, 24, stride=2),
                          ref_program.ConvPWSpec(4, 4, 24, 16),
                          ref_program.ConvPWSpec(4, 4, 16, 16,
                                                 resample_to=(3, 3)),
                          ref_program.AvgPoolSpec(3, 3, 16),
                          ref_program.GemmSpec(10)]),
        "residual": (36, 16, [ref_program.ConvPWSpec(6, 6, 16, 48,
                                                     activation="relu"),
                              ref_program.ConvDWSpec(6, 6, 48),
                              ref_program.ConvPWSpec(6, 6, 48, 16),
                              ref_program.ResidualAddSpec(3, "relu"),
                              ref_program.IBModuleSpec(cfg)]),
        "branch": (64, 8, [ref_program.ConvK2DSpec(8, 8, 8, 16, stride=2),
                           ref_program.ConvK2DSpec(4, 4, 16, 16),
                           ref_program.ConvPWSpec(8, 8, 8, 16, stride=2,
                                                  input_from=2),
                           ref_program.ResidualAddSpec(2)]),
        "stream": (10, 1, [ref_program.ConvStreamSpec(
                               49, 10, 1, 64, k=5, stride=2, hop=1,
                               activation="relu"),
                           ref_program.AvgPoolSpec(25, 5, 64),
                           ref_program.GRUCellSpec(64)]),
    }


@pytest.mark.parametrize("name", sorted(_layers()))
@pytest.mark.parametrize("block_rows,dtype", [(None, "float32"),
                                              (1, "float32"),
                                              (1, "int8"), (2, "bfloat16")])
def test_plan_program_equals_the_reference(name, block_rows, dtype):
    m, d, layers = _layers()[name]
    if block_rows == 2 and name in ("convs", "residual", "branch",
                                    "stream"):
        block_rows = 1
    kw = dict(block_rows=block_rows, dtype=dtype)
    want = ref_program.plan_program(m, d, layers, **kw)
    have = program.plan_program(m, d, [_port(s) for s in layers],
                                **kw)
    assert have.to_json_dict() == want.to_json_dict()
    assert (have.pool_bytes, have.physical_pool_bytes, have.naive_bytes,
            have.saving_fraction, have.aligned, have.executable) \
        == (want.pool_bytes, want.physical_pool_bytes, want.naive_bytes,
            want.saving_fraction, want.aligned, want.executable)
    if have.aligned:
        have.check_alignment()
    for dt in ("float32", "int8", "byte"):
        assert have.with_dtype(dt).to_json_dict() \
            == want.with_dtype(dt).to_json_dict()


@pytest.mark.parametrize("slack", [1, 2])
def test_delta_slack_shrinks_every_delta_as_the_reference(slack):
    m, d, layers = _layers()["convs"]
    want = ref_program.plan_program(m, d, layers, delta_slack=slack)
    have = program.plan_program(m, d, [_port(s) for s in layers],
                                delta_slack=slack)
    assert have.to_json_dict() == want.to_json_dict()


def test_plan_only_programs_equal_the_reference():
    cfg = gp.MCUNET_5FPS_VWW[2]
    rcfg = ref_gp.MCUNET_5FPS_VWW[2]
    for ws in ("paper_11seg", "row_cache"):
        have = program.plan_module_program(cfg, ws)
        want = ref_program.plan_module_program(rcfg, ws)
        assert have.to_json_dict() == want.to_json_dict()
        assert (have.pool_bytes, have.naive_bytes) \
            == (want.pool_bytes, want.naive_bytes)
        assert have.pool_bytes == gp.plan_inverted_bottleneck(
            cfg, ws).pool_bytes
    have = program.plan_stream_chain_program(8, [64, 256, 64],
                                             rows_per_step=2)
    want = ref_program.plan_stream_chain_program(8, [64, 256, 64],
                                                 rows_per_step=2)
    assert have.to_json_dict() == want.to_json_dict()
    with pytest.raises(ValueError, match="already"):
        have.with_dtype("float32")


@pytest.mark.parametrize("aligned", [False, True])
def test_concat_programs_equals_the_reference(aligned):
    br = 1 if aligned else None
    parts = [(4, 64, [ref_program.GemmSpec(128)]),
             (4, 128, [ref_program.GemmSpec(64, "relu"),
                       ref_program.ElementwiseSpec("gelu")])]
    want = ref_program.concat_programs(
        [ref_program.plan_program(m, d, ls, block_rows=br)
         for m, d, ls in parts])
    have = program.concat_programs(
        [program.plan_program(m, d, [_port(s) for s in ls],
                              block_rows=br) for m, d, ls in parts])
    assert have.to_json_dict() == want.to_json_dict()


def test_plan_program_refuses_what_the_reference_refuses():
    for layers, err in (([], ValueError),
                        ([program.GemmSpec(8, "tanh")], ValueError),
                        ([program.ResidualAddSpec(2)], ValueError),
                        ([program.ConvPWSpec(3, 3, 8, 8)], ValueError)):
        with pytest.raises(err):
            program.plan_program(4, 8, layers)
    with pytest.raises(ValueError, match="contradicts"):
        program.plan_program(4, 8, [program.GemmSpec(8)], elem_bytes=2,
                             dtype="float32")
    with pytest.raises(ValueError, match="tight"):
        program.plan_program(4, 8, [program.GemmSpec(8)]).check_alignment()
