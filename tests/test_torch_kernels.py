"""The port's ring kernels against the reference's Pallas kernels.

On the CPU the plain version of each kernel (``repro_torch.kernels.PLAIN``,
the ``*_plain`` functions of ``kernels/quantized.py`` and
``kernels/stream.py``) leaves a final pool bitwise equal to the
reference Pallas kernel run in interpret mode, from the same seeded pool
and parameters: on every op of DS-CNN and ResNet-8 and on the streaming
ops of ``ds-cnn-stream`` and the GRU chain, with their real weights, and
on the edge cases of ``repro_torch.kernels.cases``.  The CUDA wrappers
refuse CPU tensors.  (On the card, ``test_torch_gpu.py`` holds each CUDA
kernel to its plain version.)
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quantized as ref_quantized
from repro.kernels import stream as ref_stream
from repro_torch import load
from repro_torch.core.executors import _pw_row_block
from repro_torch.core.program import PoolOp
from repro_torch.kernels import KERNELS, PLAIN, launch_counts
from repro_torch.kernels.cases import (EDGE_CASES, case_inputs,
                                       program_cases)

ASSETS = (pathlib.Path(__file__).resolve().parents[1] / "src"
          / "repro_torch" / "assets")
ASSET = ASSETS / "ds-cnn.cortex-m4.int8.json"
STREAM_KINDS = ("conv_stream", "gru_cell")


def _cases(name: str, prefix: str, kinds=None):
    cn = load(ASSETS / f"{name}.cortex-m4.int8.json")
    return program_cases(cn.program, cn.qnet.qparams,
                         kernel_block_rows=cn.target.kernel_block_rows,
                         prefix=prefix, kinds=kinds)


DS_CNN_CASES = _cases("ds-cnn", "")
RESNET_CASES = _cases("resnet-8", "resnet-8_")
STREAM_CASES = _cases("ds-cnn-stream", "ds-cnn-stream_", STREAM_KINDS) \
    + _cases("kws-gru-chain", "kws-gru-chain_", STREAM_KINDS)
CASES = DS_CNN_CASES + EDGE_CASES + RESNET_CASES + STREAM_CASES


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _reference_kernel(name: str):
    return getattr(ref_quantized, name, None) or getattr(ref_stream, name)


def _reference_pool(case, pool, params) -> np.ndarray:
    fn = _reference_kernel(case.kernel)
    out = fn(jnp.asarray(pool), *(jnp.asarray(p) for p in params),
             **case.kwargs, interpret=True)
    return np.asarray(out)


def _plain_pool(case, pool, params) -> torch.Tensor:
    p = torch.from_numpy(pool.copy())
    PLAIN[case.kernel](p, *(torch.from_numpy(a) for a in params),
                       **case.kwargs)
    return p


def test_ds_cnn_cases_cover_every_op_and_all_five_kernels():
    cn = load(ASSET)
    assert len(DS_CNN_CASES) == len(cn.program.ops) == 11
    assert {c.kernel for c in DS_CNN_CASES} == {
        "ring_gemm_q", "ring_conv_pw_q", "ring_conv_dw_q",
        "ring_conv_k2d_q", "ring_avgpool_q"}
    stem = DS_CNN_CASES[0].kwargs
    # the stem's 490-row input read wraps the 500-segment ring
    assert stem["in_ptr"] + stem["h_in"] * stem["w_in"] > cn.program.n_segments


def test_cases_cover_all_eight_kernels_and_resnet_8():
    int8 = {name for name in KERNELS if name.endswith("_q")}
    assert {c.kernel for c in CASES} == int8
    assert set(KERNELS) == set(PLAIN)
    assert len(int8) == 8
    assert len(RESNET_CASES) == 14
    assert sum(c.kernel == "ring_add_q" for c in RESNET_CASES) == 3
    assert {c.kernel for c in STREAM_CASES} == {"ring_conv_stream_q",
                                                "ring_gru_cell_q"}


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_plain_version_bitwise_equals_pallas_kernel(case):
    pool, params = case_inputs(case, seed=0)
    want = _reference_pool(case, pool, params)
    got = _plain_pool(case, pool, params).numpy()
    assert not np.array_equal(want, pool), "the kernel stored nothing"
    np.testing.assert_array_equal(got, want)


def test_edge_cases_reach_the_int32_limits():
    """The saturating add sums two operands at the 2**24 clip, and the
    GRU case's biases wrap ``gx + b`` past the int32 limits."""
    (add,) = [c for c in EDGE_CASES if c.name == "add_saturating"]
    pool, _ = case_inputs(add, seed=0)
    got = _plain_pool(add, pool, ()).numpy()
    out = got[16:24, :64]
    assert {-128, 127} <= set(np.unique(out).tolist()) <= {-128, 0, 127}
    (gru,) = [c for c in EDGE_CASES if c.name == "gru_bias_wraps"]
    b = gru.params[2].astype(np.int64)
    assert (np.abs(b) > (1 << 31) - (1 << 12) - 1).all()


def test_pw_row_block_case_is_what_the_executor_picks():
    (case,) = [c for c in EDGE_CASES if c.name == "pw_row_block"]
    kw = case.kwargs
    op = PoolOp(kind="conv_pw", in_ptr=kw["in_ptr"], out_ptr=kw["out_ptr"],
                delta=0, in_segments=32, out_segments=32, segment_bytes=128,
                d_in=kw["c_in"], d_out=kw["c_out"], h_in=kw["h_in"],
                w_in=kw["w_in"], h_out=kw["h_out"], w_out=kw["w_out"])
    assert _pw_row_block(op, case.n_seg, kw["in_ptr"], 128, 8) == \
        kw["row_block"] == 4


@pytest.mark.parametrize("case", CASES[:11:2] + EDGE_CASES[::3]
                         + EDGE_CASES[13:] + STREAM_CASES[:2],
                         ids=lambda c: c.name)
def test_wrapper_refuses_cpu_tensors(case):
    pool, params = case_inputs(case, seed=0)
    p = torch.from_numpy(pool.copy())
    before = launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        KERNELS[case.kernel](p, *(torch.from_numpy(a) for a in params),
                             **case.kwargs)
    np.testing.assert_array_equal(p.numpy(), pool)   # no plain fallback
    assert launch_counts() == before


@pytest.mark.parametrize("case", [
    c for c in CASES if c.name in ("op00_conv_k2d", "op01_conv_dw",
                                   "op02_conv_pw", "op09_pool_avg",
                                   "gemm_block_rows", "add_shifted",
                                   "stream_hop2", "gru_wide_input")],
    ids=lambda c: c.kernel)
def test_alignment_errors_match_the_reference(case):
    kernel = case.kernel
    bad = dict(case.kwargs, in_ptr=case.kwargs["in_ptr"] + 1)
    pool, params = case_inputs(case, seed=0)
    with pytest.raises(ValueError, match="align"):
        _reference_kernel(kernel)(jnp.asarray(pool),
                                  *(jnp.asarray(a) for a in params),
                                  **bad, interpret=True)
    for fn in (KERNELS[kernel], PLAIN[kernel]):
        with pytest.raises(ValueError, match="align"):
            fn(torch.from_numpy(pool.copy()),
               *(torch.from_numpy(a) for a in params), **bad)


@pytest.mark.parametrize("case", [
    c for c in EDGE_CASES if c.kernel in ("ring_conv_stream_q",
                                          "ring_gru_cell_q")],
    ids=lambda c: c.name)
def test_wrapping_state_is_refused_like_the_reference(case):
    """A state region that would wrap the ring is refused by the
    reference, the plain version and the wrapper alike."""
    pool, params = case_inputs(case, seed=0)
    n = case.n_seg
    gru = case.kernel == "ring_gru_cell_q"
    bad = dict(case.kwargs, state_ptr=n if gru else n - case.kwargs["w_in"])
    with pytest.raises(ValueError, match="wrap"):
        _reference_kernel(case.kernel)(jnp.asarray(pool),
                                       *(jnp.asarray(a) for a in params),
                                       **bad, interpret=True)
    for fn in (KERNELS[case.kernel], PLAIN[case.kernel]):
        with pytest.raises(ValueError, match="wrap"):
            fn(torch.from_numpy(pool.copy()),
               *(torch.from_numpy(a) for a in params), **bad)


def test_ctypes_signatures_match_the_cuda_entry_points():
    """Every ``extern "C"`` launcher of ``ring_q.cu``, ``ring_f32.cu`` and
    ``ring_decode.cu`` takes the pointers, ints and floats that
    ``_build.SIGNATURES`` declares, in that order (ctypes would pass a
    wrong count or type silently), and each source names its error
    codes."""
    import re

    from repro_torch.kernels import _build

    every = set()
    for stem, entries in _build.SIGNATURES.items():
        text = _build.source(stem).read_text()
        text = text[text.index('extern "C" {'):]
        assert f"const char* {stem}_error_string(int err)" in text
        found = {}
        for name, args in re.findall(r"^int (ring_\w+)\(([^)]*)\)", text,
                                     re.MULTILINE):
            found[name] = ["P" if "*" in a else "F" if "float" in a
                           else "I" for a in args.split(",")]
        declared = {name: ["P" if t is _build._P else "F" if t is _build._F
                           else "I" for t in argtypes]
                    for name, argtypes in entries.items()}
        assert found == declared, stem
        every |= set(declared)
    assert every == set(KERNELS)
