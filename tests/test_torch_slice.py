"""The port's main path on the CPU: ``repro_torch.load(artifact).run(x,
device="cpu")`` serves DS-CNN, ResNet-8, MCUNet-5fps-VWW and ToyADMOS
int8 bitwise equal to the reference, in float outputs, int8 outputs and
final-pool sha256, and refuses to run on the CPU unless asked to.
ToyADMOS is held to the reference's ring bit for bit, not to the
reference's cosine floor against its fp32 net (which that net misses)."""
import hashlib
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compile import artifact as ref_artifact
from repro.core.executors import run_program as ref_run_program
from repro.core.program import PoolProgram as RefPoolProgram
from repro.quant import QParams as RefQParams
from repro.quant import quantize as ref_quantize
from repro_torch import load
from repro_torch.compile.artifact import to_device
from repro_torch.core.executors import run_program
from repro_torch.quant.qtensor import QParams, quantize

ASSETS = (pathlib.Path(__file__).resolve().parents[1] / "src"
          / "repro_torch" / "assets")
ARTIFACT = ASSETS / "ds-cnn.cortex-m4.int8.json"
GOLDEN = ASSETS / "ds-cnn.cortex-m4.int8.golden.npz"
#: The main-path nets served from committed artifacts, by output shape.
NETS = {"ds-cnn": (8, 1, 12), "resnet-8": (8, 1, 10),
        "mcunet-5fps-vww": (8, 1, 2), "ad-toyadmos": (8, 1, 640)}


def _artifact(name):
    return ASSETS / f"{name}.cortex-m4.int8.json"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return {k: g[k] for k in g.files}


@pytest.fixture(scope="module", params=sorted(NETS))
def net(request):
    """``(name, golden)`` of each main-path net."""
    with np.load(ASSETS / f"{request.param}.cortex-m4.int8.golden.npz") as g:
        return request.param, {k: g[k] for k in g.files}


def _int8_run(cn, x):
    """The port's int8 output and final pool for one float input."""
    qparams = to_device(cn.qnet.qparams, "cpu")
    xq = quantize(torch.from_numpy(x), QParams(scale=cn.qnet.in_scale))
    return run_program(cn.program, xq, qparams,
                       kernel_block_rows=cn.target.kernel_block_rows)


def test_batched_run_bitwise_equals_golden(net):
    name, golden = net
    y = load(_artifact(name)).run(golden["x"], device="cpu")
    assert y.dtype == torch.float32 and y.device.type == "cpu"
    assert tuple(y.shape) == NETS[name]
    np.testing.assert_array_equal(y.numpy(), golden["y"])


def test_single_runs_bitwise_equal_golden(net):
    name, golden = net
    cn = load(_artifact(name))
    for i, x in enumerate(golden["x"]):
        y = cn.run(torch.from_numpy(x), device="cpu")
        np.testing.assert_array_equal(y.numpy(), golden["y"][i])


def test_int8_outputs_and_final_pools_equal_golden(net):
    name, golden = net
    cn = load(_artifact(name))
    for i, x in enumerate(golden["x"]):
        y_q, pool = _int8_run(cn, x)
        np.testing.assert_array_equal(y_q.numpy(), golden["y_q"][i])
        sha = hashlib.sha256(pool.array.numpy().tobytes()).hexdigest()
        assert sha == golden["pool_sha256"][i], i


def test_one_input_equals_the_reference_pallas_path(golden):
    """The reference decodes the committed artifact itself (its own
    ``repro.load`` needs the fp32 ``params`` the port's artifacts drop)
    and runs it on its Pallas kernels."""
    x = golden["x"][3]
    payload = ref_artifact.load(str(ARTIFACT))
    program = RefPoolProgram.from_json_dict(payload["program"])
    qparams = ref_artifact.decode(payload["quant"]["qparams"])
    in_scale = payload["quant"]["act_scales"][0]
    yq_ref, pool_ref = ref_run_program(
        program, ref_quantize(jnp.asarray(x), RefQParams(in_scale)),
        qparams, backend="pallas",
        kernel_block_rows=payload["target"]["kernel_block_rows"])
    y_q, pool = _int8_run(load(ARTIFACT), x)
    np.testing.assert_array_equal(y_q.numpy(), np.asarray(yq_ref))
    np.testing.assert_array_equal(pool.array.numpy(),
                                  np.asarray(pool_ref.array))


def test_run_defaults_to_cuda_and_refuses_without_it(golden, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cn = load(ARTIFACT)
    with pytest.raises(RuntimeError, match="CUDA"):
        cn.run(golden["x"][0])
    with pytest.raises(RuntimeError, match="CUDA"):
        cn.run(golden["x"][0], device="cuda")


def test_residual_nets_run_every_add_and_carry_no_fp32_params():
    """ResNet-8 (3 adds) and VWW (7 adds) reach the residual kernel; the
    committed artifacts carry no fp32 ``params`` and load all the same."""
    import json

    for name, adds in (("resnet-8", 3), ("mcunet-5fps-vww", 7)):
        assert "params" not in json.loads(_artifact(name).read_text())
        cn = load(_artifact(name))
        assert cn.quantized
        assert sum(op.kind == "add" for op in cn.program.ops) == adds
        kinds = {op.kind for op, p in zip(cn.program.ops, cn.qnet.qparams)
                 if op.kind == "add" and len(p) == 4}
        assert kinds == {"add"}
