"""The port on a CUDA card: each hand-written kernel against its plain
version, and the served main path against the reference's golden.

These tests import neither JAX nor the reference package, so they run
on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card they skip (the decision is taken inside each test).
"""
import hashlib
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import load
from repro_torch.compile.artifact import to_device
from repro_torch.core.executors import run_program
from repro_torch.kernels import quantized as qk
from repro_torch.kernels.cases import (EDGE_CASES, case_inputs,
                                       program_cases)
from repro_torch.quant.qtensor import QParams, quantize

ASSETS = (pathlib.Path(__file__).resolve().parents[1] / "src"
          / "repro_torch" / "assets")
ARTIFACT = ASSETS / "ds-cnn.cortex-m4.int8.json"
GOLDEN = ASSETS / "ds-cnn.cortex-m4.int8.golden.npz"

_CN = load(ARTIFACT)
CASES = program_cases(_CN.program, _CN.qnet.qparams,
                      kernel_block_rows=_CN.target.kernel_block_rows) \
    + EDGE_CASES


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_cuda_kernel_bitwise_equals_plain_on_card(case):
    _need_card()
    pool, params = case_inputs(case, seed=0)
    cuda_params = [torch.from_numpy(a).cuda() for a in params]
    want = torch.from_numpy(pool).cuda()
    qk.PLAIN[case.kernel](want, *cuda_params, **case.kwargs)
    got = torch.from_numpy(pool).cuda()
    qk.KERNELS[case.kernel](got, *cuda_params, **case.kwargs)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_served_main_path_equals_golden_on_card():
    _need_card()
    cn = load(ARTIFACT)
    with np.load(GOLDEN) as g:
        golden = {k: g[k] for k in g.files}
    qk.reset_launch_counts()
    y = cn.run(golden["x"])
    torch.cuda.synchronize()
    assert y.device.type == "cuda"
    assert qk.launch_counts() == {
        "ring_gemm_q": 8, "ring_conv_pw_q": 32, "ring_conv_dw_q": 32,
        "ring_conv_k2d_q": 8, "ring_avgpool_q": 8}
    np.testing.assert_array_equal(y.cpu().numpy(), golden["y"])
    qparams = to_device(cn.qnet.qparams, "cuda")
    for i, x in enumerate(golden["x"]):
        xq = quantize(torch.from_numpy(x).cuda(),
                      QParams(scale=cn.qnet.in_scale))
        y_q, pool = run_program(cn.program, xq, qparams)
        np.testing.assert_array_equal(y_q.cpu().numpy(), golden["y_q"][i])
        sha = hashlib.sha256(pool.array.cpu().numpy().tobytes()).hexdigest()
        assert sha == golden["pool_sha256"][i]
