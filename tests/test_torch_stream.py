"""The port's streaming entry point on the CPU: ``CompiledNet.stream(
device="cpu")`` steps bitwise equal to the reference ``StreamSession``
(``backend="jnp"``), frame by frame, and to the committed goldens of
``ds-cnn-stream`` and the keyword-spotting GRU chain over 60 frames."""
import hashlib
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.analysis import verify_program
from repro.compile import artifact as ref_artifact
from repro.compile.driver import CompiledNet as RefCompiledNet
from repro.compile.targets import get_target
from repro.core.program import (AvgPoolSpec, ConvDWSpec, ConvPWSpec,
                                ConvStreamSpec, GemmSpec, GRUCellSpec,
                                plan_program)
from repro.graph.run import _quantize_net, init_net_params
from repro.quant import QParams as RefQParams
from repro.quant import quantize as ref_quantize
from repro_torch import load
from repro_torch.kernels import launch_counts

ASSETS = (pathlib.Path(__file__).resolve().parents[1] / "src"
          / "repro_torch" / "assets")
STREAMS = ("ds-cnn-stream", "kws-gru-chain")
KEY = jax.random.PRNGKey(7)
# the tests/test_stream.py chain geometry
H_WIN, W_, C_IN, C_OUT, HOP, D_H = 6, 5, 8, 16, 2, 24


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _kws_like():
    """A small streaming DS-CNN: conv_stream stem, one depthwise-
    separable block, average pool, FC head."""
    prog = plan_program(W_, 1, [
        ConvStreamSpec(H_WIN, W_, 1, C_OUT, k=3, stride=2, hop=1,
                       activation="relu"),
        ConvDWSpec(3, 3, C_OUT, activation="relu"),
        ConvPWSpec(3, 3, C_OUT, C_OUT, activation="relu"),
        AvgPoolSpec(3, 3, C_OUT), GemmSpec(6)], block_rows=1)
    return prog, init_net_params(prog, KEY)


def _chain():
    prog = plan_program(HOP * W_, C_IN, [
        ConvStreamSpec(H_WIN, W_, C_IN, C_OUT, k=3, hop=HOP,
                       activation="relu"),
        AvgPoolSpec(H_WIN, W_, C_OUT), GRUCellSpec(D_H)], block_rows=1)
    k1, k2, k3, k4, k5 = jax.random.split(KEY, 5)
    params = [(jax.random.normal(k1, (3, 3, C_IN, C_OUT)) / (9 * C_IN) ** 0.5,
               jax.random.normal(k2, (C_OUT,)) / 8), None,
              (jax.random.normal(k3, (C_OUT, 3 * D_H)) / C_OUT ** 0.5,
               jax.random.normal(k4, (D_H, 3 * D_H)) / D_H ** 0.5,
               jax.random.normal(k5, (3 * D_H,)) / 8)]
    return prog, params


PROGRAMS = {"kws-like": _kws_like, "chain": _chain}


def _compiled(name: str, tmp_path):
    """The reference ``CompiledNet`` of a small streaming program and the
    port's, loaded from the artifact the reference saves."""
    prog, params = PROGRAMS[name]()
    qnet = _quantize_net(prog, params)
    cert = verify_program(qnet.program).certificate(
        ref_artifact.program_sha256(qnet.program))
    ref = RefCompiledNet(net_name=name, target=get_target("cortex-m4"),
                         dtype="int8", program=qnet.program, params=params,
                         qnet=qnet, mcu={}, certificate=cert, passes=[])
    path = tmp_path / f"{name}.json"
    ref.save(str(path))
    return ref, load(path)


def _frames(program, n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (n, program.ops[0].rows_in, program.in_dim), np.float32)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_session_steps_bitwise_equal_reference_session(name, tmp_path):
    ref, cn = _compiled(name, tmp_path)
    qn = ref.qnet
    frames = _frames(ref.program, 2 * H_WIN + 3)
    fq = np.asarray(ref_quantize(frames, RefQParams(scale=qn.in_scale)))
    want = ref.stream(backend="jnp")
    got = cn.stream(device="cpu")
    assert got.state_segments == want.state_segments
    assert got.state_bytes == want.state_bytes
    for i, f in enumerate(fq):
        y_ref = np.asarray(want.step(f))
        y = got.step(torch.tensor(f))
        assert y.dtype == torch.int8 and y.device.type == "cpu"
        np.testing.assert_array_equal(y.numpy(), y_ref, err_msg=f"step {i}")
        np.testing.assert_array_equal(got.pool.array.numpy(),
                                      np.asarray(want._pool.array))
    assert got.steps == want.steps == len(fq)
    # float frames quantize on entry and dequantize on exit
    want.reset()
    got.reset()
    for f in frames[:4]:
        np.testing.assert_array_equal(got.step(f).numpy(),
                                      np.asarray(want.step(f)))


def test_reset_zeroes_the_state_and_replays(tmp_path):
    _, cn = _compiled("chain", tmp_path)
    frames = _frames(cn.program, 6, seed=1)
    s = cn.stream(device="cpu")
    first = [s.step(f) for f in frames]
    assert s.pool.array.abs().sum() > 0
    assert s.reset() is s and s.steps == 0
    assert not s.pool.array.any()
    again = [s.step(f) for f in frames]
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # run() feeds every frame and returns the last output
    s.reset()
    np.testing.assert_array_equal(s.run(frames).numpy(), first[-1].numpy())


@pytest.mark.parametrize("name", STREAMS)
def test_stream_asset_equals_its_golden_step_by_step(name):
    cn = load(ASSETS / f"{name}.cortex-m4.int8.json")
    with np.load(ASSETS / f"{name}.cortex-m4.int8.golden.npz") as g:
        golden = {k: g[k] for k in g.files}
    s = cn.stream(device="cpu")
    before = launch_counts()
    for i, f in enumerate(golden["x_q"]):
        y = s.step(torch.from_numpy(f))
        np.testing.assert_array_equal(y.numpy(), golden["y_q"][i],
                                      err_msg=f"step {i}")
    assert launch_counts() == before        # the CPU ran plain versions
    sha = hashlib.sha256(s.pool.array.numpy().tobytes()).hexdigest()
    assert sha == str(golden["pool_sha256"])
    s.reset()
    for i, f in enumerate(golden["x"][:8]):
        np.testing.assert_array_equal(s.step(f).numpy(), golden["y"][i])


def test_stream_refuses_what_is_not_ported_or_not_there(monkeypatch):
    cn = load(ASSETS / "ds-cnn-stream.cortex-m4.int8.json")
    # the sim backend (the clobber oracle) is ported: it needs no device
    # and steps to the oracle's counters
    counters = cn.stream(backend="sim").step()
    assert counters["steps"] == 1 and counters["live"] > 0
    # trace=True is ported: one artifact per step, the same outputs
    traced, plain = cn.stream(device="cpu", trace=True), cn.stream(
        device="cpu")
    frame = torch.zeros((cn.program.ops[0].rows_in, cn.program.in_dim),
                        dtype=torch.int8)
    assert torch.equal(traced.step(frame), plain.step(frame))
    assert len(traced.traces) == 1 and traced.traces[0].backend == "cpu"
    with pytest.raises(ValueError, match="backend"):
        cn.stream(device="cpu", backend="pallas")
    with pytest.raises(ValueError, match="no stream state"):
        load(ASSETS / "ds-cnn.cortex-m4.int8.json").stream(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cn.stream()
