"""The sliced ImageNet int8 plan's ops on the CPU models of their kernels.

The plan (``assets/mcunet-320kb-imagenet.cortex-m4.int8.sliced.json``)
runs 98 pointwise and 48 depthwise convs, 31 of them reading a window of
a held source (``in_row0``) and 36 writing into a record shared by the
slices of their group (``out_op``, ``out_row0``).  Each is held here as
the other plans' ops are in ``tests/test_torch_q_conv_tiles.py`` and
``tests/test_torch_q_dw_add_tiles.py``, with their helpers:

  * the tiling of ``conv2d.conv_tiling`` stores every output once, fits
    shared memory and stages every input row the taps reach, on 132, 114
    and 16 SMs;
  * the model of the read-first kernel (every CTA reads the pool as it
    was before the op, then all store) is bitwise the plain version;
  * every add's mode (``quantized.add_needs_barrier``) is the
    brute-force check's, and all ten take the row map.
"""
import pathlib

import pytest
import torch

from repro_torch import load
from repro_torch.kernels.cases import program_cases
from repro_torch.kernels.conv2d import conv_tiling
from test_torch_q_conv_tiles import _cta_stores, _hold_tiling, _inputs
from test_torch_q_dw_add_tiles import (_brute_needs_barrier, _dw_cta_stores,
                                       _hold_dw_tiling, _needs_barrier,
                                       _plain, _ptrs)

ASSETS = (pathlib.Path(__file__).resolve().parents[1] / "src"
          / "repro_torch" / "assets")
SLICED = ASSETS / "mcunet-320kb-imagenet.cortex-m4.int8.sliced.json"
N_SM = (132, 114, 16)


def _sliced_cases():
    cn = load(SLICED)
    return program_cases(cn.program, cn.qnet.qparams,
                         kernel_block_rows=cn.target.kernel_block_rows,
                         prefix="sliced_")


CASES = _sliced_cases()
PW = tuple(c for c in CASES if c.kernel == "ring_conv_pw_q")
DW = tuple(c for c in CASES if c.kernel == "ring_conv_dw_q")
ADD = tuple(c for c in CASES if c.kernel == "ring_add_q")


def test_the_sliced_plan_has_the_ops_held_here():
    assert (len(CASES), len(PW), len(DW), len(ADD)) == (158, 98, 48, 10)
    assert {c.kernel for c in CASES} == {
        "ring_conv_pw_q", "ring_conv_dw_q", "ring_add_q", "ring_avgpool_q",
        "ring_gemm_q"}


@pytest.mark.parametrize("n_sm", N_SM)
@pytest.mark.parametrize("case", PW + DW, ids=lambda c: c.name)
def test_sliced_tiles_cover_every_output_once_and_fit(case, n_sm):
    if case.kernel == "ring_conv_pw_q":
        t = _hold_tiling(case.kernel, case.kwargs, n_sm)
    else:
        t = _hold_dw_tiling(case.kwargs, n_sm)
    assert t.ctas >= min(4, n_sm)


@pytest.mark.parametrize("case", PW + DW, ids=lambda c: c.name)
def test_sliced_reading_first_is_bitwise_the_plain_version(case):
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
def test_sliced_adds_take_the_row_map(case):
    kw = case.kwargs
    assert _needs_barrier(case) is False
    assert _brute_needs_barrier(case.n_seg, kw["rows"], kw["d"],
                                *_ptrs(case)) is False
