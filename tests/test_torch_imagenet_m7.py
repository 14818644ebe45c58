"""The unsliced MCUNet-320KB-ImageNet on the port's main path, against
the reference on the CPU, and its int8 ops on the CPU models of their
kernels.

The committed assets (``tests/test_torch_assets.py --zoo
mcunet-320kb-imagenet`` writes them) are the reference's
``repro.compile("mcunet-320kb-imagenet", "cortex-m7")`` (int8: 65 ops,
pw 36, dw 17, add 10, pool and a 96 -> 1000 FC head, on a 31,680-segment
ring of 3,964,928 B) and its ``host-sim`` fp32 twin (36 ops: 10 fused
inverted bottlenecks, pw 16, dw 7, add, pool and the head; 15,859,712
B), each with a golden of 2 seeded 176 x 176 x 3 inputs and the
reference's ``run(x, backend="jnp")`` outputs.  Held here:

* each asset is a fresh reference compile's and each golden a fresh
  reference run's (the reference compiles the two plans once for the
  module: about 43 s and 1.4 s, and runs its goldens in about 47 s);
* the port's plain path, ``load(artifact).run(x, device="cpu")``: the
  int8 float outputs, int8 outputs and final-pool sha256 bitwise; the
  fp32 outputs within rtol 3e-4, atol 3e-5 * max and each final pool
  within it of the reference's on the live channels, exact on channel
  tails and unwritten lanes;
* the int8 plan's ops on the models of their kernels, as
  ``tests/test_torch_q_conv_tiles.py``, ``test_torch_q_dw_add_tiles.py``
  and ``test_torch_q_stream_gemm_tiles.py`` hold the other plans': every
  pw and dw op under ``conv2d.conv_tiling`` on 132, 114 and 16 SMs
  stores every output once, fits ``MAX_SMEM`` and stages every input row
  its taps reach, and read first is bitwise the plain version (the
  fewest CTAs, 11, are a dw's); all ten adds take the barrier-free row
  map (``quantized.add_needs_barrier`` False, as a brute-force check
  says); the head runs column tiles under a grid barrier
  (``quantized.gemm_q_tiling``: 63 CTAs) that store every output once,
  and read first is bitwise the plain version.

``chip_smoke.py`` serves both plans on the card against the same goldens.
"""
import pytest
import torch

from repro_torch import load
from repro_torch.kernels.cases import program_cases
from repro_torch.kernels.conv2d import conv_tiling
from test_torch_assets import (FLOAT_TARGET, artifact_path,
                               compile_float_reference, compile_reference,
                               hold_fresh_zoo_assets, hold_port_zoo_float,
                               hold_port_zoo_int8, op_kinds)
from test_torch_q_conv_tiles import _cta_stores, _hold_tiling, _inputs
from test_torch_q_dw_add_tiles import (_brute_needs_barrier, _dw_cta_stores,
                                       _hold_dw_tiling, _needs_barrier,
                                       _plain, _ptrs)
from test_torch_q_stream_gemm_tiles import _gemm_tiling, _reading_first
from test_torch_q_stream_gemm_tiles import \
    test_gemm_tiles_cover_every_output_once_and_fit as _hold_gemm_tiling

NET = "mcunet-320kb-imagenet"
N_SM = (132, 114, 16)


def _cases():
    cn = load(artifact_path(NET))
    return program_cases(cn.program, cn.qnet.qparams,
                         kernel_block_rows=cn.target.kernel_block_rows,
                         prefix="m7_")


CASES = _cases()
PW = tuple(c for c in CASES if c.kernel == "ring_conv_pw_q")
DW = tuple(c for c in CASES if c.kernel == "ring_conv_dw_q")
ADD = tuple(c for c in CASES if c.kernel == "ring_add_q")
HEAD = tuple(c for c in CASES if c.kernel == "ring_gemm_q")


@pytest.fixture(scope="module")
def reference():
    """The reference's int8 and fp32 compiles of the net, made once."""
    return compile_reference(NET), compile_float_reference(NET)


def test_the_assets_are_a_fresh_reference_compile_and_run(reference):
    hold_fresh_zoo_assets(NET, *reference)


def test_the_plans_are_imagenet_for_the_m7_and_the_host(reference):
    ref_q, ref_f = reference
    assert op_kinds(ref_q) == {"add": 10, "conv_dw": 17, "conv_pw": 36,
                               "gemm": 1, "pool_avg": 1}
    assert op_kinds(ref_f) == {"add": 1, "conv_dw": 7, "conv_pw": 16,
                               "gemm": 1, "ib_fused": 10, "pool_avg": 1}
    assert (ref_q.target.name, ref_q.dtype) == ("cortex-m7", "int8")
    assert (ref_f.target.name, ref_f.dtype) == (FLOAT_TARGET, "float32")
    for cn, ring in ((ref_q, 3_964_928), (ref_f, 15_859_712)):
        assert cn.program.n_segments == 31_680
        assert cn.program.pool_bytes == ring
    ib = [op for op in ref_f.program.ops if op.kind == "ib_fused"]
    assert max(op.rs for op in ib) == 7 and max(op.d_mid for op in ib) == 384
    assert max(op.w_in for op in ib if op.rs == 7) == 44
    head = ref_f.program.ops[-1]
    assert (head.kind, head.d_in, head.d_out) == ("gemm", 96, 1000)


def test_the_port_runs_the_int8_plan_bitwise():
    hold_port_zoo_int8(NET)


def test_the_port_runs_the_fp32_plan_within_the_tolerance(reference):
    hold_port_zoo_float(NET, reference[1])


def test_the_int8_plan_has_the_ops_held_here():
    assert (len(CASES), len(PW), len(DW), len(ADD), len(HEAD)) == \
        (65, 36, 17, 10, 1)
    assert min(conv_tiling(c.kernel, c.kwargs, 132).ctas for c in DW) == 11


@pytest.mark.parametrize("n_sm", N_SM)
@pytest.mark.parametrize("case", PW + DW, ids=lambda c: c.name)
def test_m7_tiles_cover_every_output_once_and_fit(case, n_sm):
    if case.kernel == "ring_conv_pw_q":
        _hold_tiling(case.kernel, case.kwargs, n_sm)
    else:
        _hold_dw_tiling(case.kwargs, n_sm)


@pytest.mark.parametrize("case", PW + DW, ids=lambda c: c.name)
def test_m7_reading_first_is_bitwise_the_plain_version(case):
    pool, params = _inputs(case)
    t = conv_tiling(case.kernel, case.kwargs)
    stores = _cta_stores if case.kernel == "ring_conv_pw_q" \
        else _dw_cta_stores
    got = pool.clone()
    for seg, lanes, values in [stores(case, t, i, pool, params)
                               for i in reversed(range(t.ctas))]:
        got[seg, lanes] = values
    assert torch.equal(got, _plain(case, pool, params))


@pytest.mark.parametrize("case", ADD, ids=lambda c: c.name)
def test_m7_adds_take_the_row_map(case):
    kw = case.kwargs
    assert _needs_barrier(case) is False
    assert _brute_needs_barrier(case.n_seg, kw["rows"], kw["d"],
                                *_ptrs(case)) is False


@pytest.mark.parametrize("n_sm", N_SM)
def test_m7_head_tiles_cover_every_output_once_and_fit(n_sm):
    _hold_gemm_tiling(HEAD[0], n_sm)


def test_m7_head_reads_first_over_column_tiles():
    case = HEAD[0]
    kw = case.kwargs
    assert (kw["m_rows"], kw["d_in"], kw["d_out"]) == (1, 96, 1000)
    t = _gemm_tiling(case)
    assert t.barrier and (t.rows, t.ctile, t.ctas) == (1, 16, 63)
    pool, params = _inputs(case)
    assert torch.equal(_reading_first(case, t, pool, params),
                       _plain(case, pool, params))
