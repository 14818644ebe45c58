"""The port's ring kernels against the reference's Pallas kernels.

On the CPU the plain version of each kernel
(``repro_torch.kernels.quantized.*_plain``) leaves a final pool bitwise
equal to the reference Pallas kernel run in interpret mode, from the
same seeded pool and parameters: on every op of DS-CNN with its real
weights, and on the edge cases of ``repro_torch.kernels.cases``.  The
CUDA wrappers refuse CPU tensors.  (On the card, ``test_torch_gpu.py``
holds each CUDA kernel to its plain version.)
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quantized as ref_kernels
from repro_torch import load
from repro_torch.core.executors import _pw_row_block
from repro_torch.core.program import PoolOp
from repro_torch.kernels import quantized as qk
from repro_torch.kernels.cases import (EDGE_CASES, case_inputs,
                                       program_cases)

ASSET = (pathlib.Path(__file__).resolve().parents[1] / "src"
         / "repro_torch" / "assets" / "ds-cnn.cortex-m4.int8.json")


def _ds_cnn_cases():
    cn = load(ASSET)
    return program_cases(cn.program, cn.qnet.qparams,
                         kernel_block_rows=cn.target.kernel_block_rows)


DS_CNN_CASES = _ds_cnn_cases()
CASES = DS_CNN_CASES + EDGE_CASES


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _reference_pool(case, pool, params) -> np.ndarray:
    fn = getattr(ref_kernels, case.kernel)
    out = fn(jnp.asarray(pool), *(jnp.asarray(p) for p in params),
             **case.kwargs, interpret=True)
    return np.asarray(out)


def _plain_pool(case, pool, params) -> torch.Tensor:
    p = torch.from_numpy(pool.copy())
    qk.PLAIN[case.kernel](p, *(torch.from_numpy(a) for a in params),
                          **case.kwargs)
    return p


def test_ds_cnn_cases_cover_every_op_and_all_five_kernels():
    cn = load(ASSET)
    assert len(DS_CNN_CASES) == len(cn.program.ops) == 11
    assert {c.kernel for c in DS_CNN_CASES} == set(qk.KERNELS)
    stem = DS_CNN_CASES[0].kwargs
    # the stem's 490-row input read wraps the 500-segment ring
    assert stem["in_ptr"] + stem["h_in"] * stem["w_in"] > cn.program.n_segments


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_plain_version_bitwise_equals_pallas_kernel(case):
    pool, params = case_inputs(case, seed=0)
    want = _reference_pool(case, pool, params)
    got = _plain_pool(case, pool, params).numpy()
    assert not np.array_equal(want, pool), "the kernel stored nothing"
    np.testing.assert_array_equal(got, want)


def test_pw_row_block_case_is_what_the_executor_picks():
    (case,) = [c for c in EDGE_CASES if c.name == "pw_row_block"]
    kw = case.kwargs
    op = PoolOp(kind="conv_pw", in_ptr=kw["in_ptr"], out_ptr=kw["out_ptr"],
                delta=0, in_segments=32, out_segments=32, segment_bytes=128,
                d_in=kw["c_in"], d_out=kw["c_out"], h_in=kw["h_in"],
                w_in=kw["w_in"], h_out=kw["h_out"], w_out=kw["w_out"])
    assert _pw_row_block(op, case.n_seg, kw["in_ptr"], 128, 8) == \
        kw["row_block"] == 4


@pytest.mark.parametrize("case", CASES[:11:2] + EDGE_CASES[::3],
                         ids=lambda c: c.name)
def test_wrapper_refuses_cpu_tensors(case):
    pool, params = case_inputs(case, seed=0)
    p = torch.from_numpy(pool.copy())
    before = qk.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        qk.KERNELS[case.kernel](p, *(torch.from_numpy(a) for a in params),
                                **case.kwargs)
    np.testing.assert_array_equal(p.numpy(), pool)   # no plain fallback
    assert qk.launch_counts() == before


@pytest.mark.parametrize("case", [
    c for c in CASES if c.name in ("op00_conv_k2d", "op01_conv_dw",
                                   "op02_conv_pw", "op09_pool_avg",
                                   "gemm_block_rows")], ids=lambda c: c.kernel)
def test_alignment_errors_match_the_reference(case):
    kernel = case.kernel
    bad = dict(case.kwargs, in_ptr=case.kwargs["in_ptr"] + 1)
    pool, params = case_inputs(case, seed=0)
    with pytest.raises(ValueError, match="align"):
        getattr(ref_kernels, kernel)(jnp.asarray(pool),
                                     *(jnp.asarray(a) for a in params),
                                     **bad, interpret=True)
    for fn in (qk.KERNELS[kernel], qk.PLAIN[kernel]):
        with pytest.raises(ValueError, match="align"):
            fn(torch.from_numpy(pool.copy()),
               *(torch.from_numpy(a) for a in params), **bad)
