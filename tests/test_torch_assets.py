"""The port's committed plan artifacts and golden outputs, held against a
fresh compile and a fresh run of the reference.

``repro_torch`` serves plans that the reference compiler writes; the
machine with the GPU has no JAX, so the artifacts and the reference's
outputs on them are committed with the port.  A stale asset fails here,
not on the card.  Run this file as a script to rewrite them all:

    PYTHONPATH=src python tests/test_torch_assets.py

The int8 artifacts are the reference's ``CompiledNet.save`` without the
fp32 ``params`` entry, which an int8 plan never reads.  Five kinds of
asset:

  * main-path int8 nets (``NETS``): the golden holds the float outputs,
    int8 outputs and final-pool sha256 of 8 inputs;
  * main-path fp32 nets (``FLOAT_NETS``, compiled for ``host-sim``): the
    artifact is the reference's ``save()`` output with its fp32
    ``params``; the golden holds 8 inputs and the reference's
    ``run(x, backend="pallas")`` outputs for them (Pallas in interpret
    mode).  fp32 pools are compared by tolerance, so no pool hash;
  * fp32 streaming plans (``FLOAT_STREAMS``, ``host-sim``): the two
    streams below left unquantized, saved with their fp32 ``params``;
    the golden holds 60 seeded frames and the reference session's
    output of each step (``backend="jnp"``);
  * seeded fp32 plans (``SEEDED_FLOAT_NETS``, ``host-sim``), whose
    weights are too large to commit: ``whisper-tiny-mlp`` is the
    reference's compile of ``graph/ir.py::build_mlp_tower`` at
    whisper-tiny's width and depth (4 ungated tanh-gelu residual layers,
    d_model 384, d_ff 1536) over its encoder's 1,500 rows, plus one
    elementwise gelu, with the weights of
    ``repro_torch.kernels.cases.mlp_tower_params(program, PARAMS_SEED)``.
    The artifact is saved with ``"params": null`` (ints only); the golden
    holds the sha256 of 2 inputs drawn by ``golden_inputs`` and the
    reference's ``run(x, backend="jnp")`` outputs on ``GOLDEN_ROWS``
    (rows are independent under a delta-0 op, so a row subset is a true
    check);
  * the compile inputs of ``COMPILE_NET`` (``ds-cnn.cortex-m4.int8.
    compile.npz``): the float params and the ``n_calib=2`` calibration
    inputs that the reference's default ``compile("ds-cnn",
    "cortex-m4")`` draws, which the port's own ``repro_torch.compile``
    takes on the card (``repro_torch.compile.artifact.
    read_compile_inputs``);
  * streaming plans (``STREAMS``): ``ds-cnn-stream`` is
    ``repro.compile("ds-cnn", streaming=True)``; ``kws-gru-chain`` is the
    conv_stream -> avgpool -> GRU program of ``tests/test_stream.py`` at
    the DS-CNN stem's width, calibrated by the reference.  The golden
    holds the int8 output of each of 60 steps from pre-quantized frames
    and the pool's sha256 after the last;
  * the sliced plan (``SLICED_NET``, ``mcunet-320kb-imagenet.cortex-m4.
    int8.sliced.json``): the reference's ``compile("mcunet-320kb-imagenet",
    "cortex-m4", dtype="int8", partial="auto", certify="static")``, 158
    ops, without the fp32 ``params``; its golden holds 2 seeded inputs, the
    reference's ``run(x, backend="jnp")`` outputs, int8 outputs and
    final-pool sha256.  Its int8 compile calibrates ImageNet (about 40 s),
    so only the script writes it; the tests hold its plan against a fresh
    planner-only compile (``quantize=False``, the same program);
  * the zoo plans of the main path (``ZOO_NETS``: MobileNetV1-0.25 for
    the cortex-m4, the unsliced MCUNet-320KB-ImageNet for the cortex-m7,
    each also fp32 for ``host-sim``; the int8 target of every plan is
    ``repro_torch.kernels.cases.INT8_TARGETS``'): the reference's
    compiles, the int8 ones without the fp32 ``params``; each golden
    holds 2 seeded inputs and the reference's ``run(x, backend="jnp")``
    outputs (int8: also the int8 outputs and final-pool sha256).  The
    per-net files ``tests/test_torch_mobilenet.py`` and
    ``tests/test_torch_imagenet_m7.py`` hold them
    (``hold_fresh_zoo_assets``, ``hold_port_zoo_int8``,
    ``hold_port_zoo_float``), each compiling its net once;
    ``write_assets`` writes them after the others.

``--sliced`` rewrites the sliced plan alone, ``--zoo [NAME ...]`` the
zoo plans (MobileNet about 40 s, ImageNet about 100 s):

    PYTHONPATH=src python tests/test_torch_assets.py --sliced
    PYTHONPATH=src python tests/test_torch_assets.py --zoo mobilenetv1-0.25

And one LM golden, written only by the ``--lm`` mode, never by pytest:

    PYTHONPATH=src python tests/test_torch_assets.py --lm

``gemma3-1b.golden.npz`` is the reference ``Model(get_config("gemma3-1b"))``
at full width and depth (1.0 B parameters, ``lm_params(cfg, 0)``) on the
CPU: for 2 seeded prompts of 8 and 24 tokens, each at batch 1, the
reference's greedy tokens of 8 steps and each step's top-64 logits and
ids and max |logit|, with the recipe's seed and version.  The same mode
writes ``gemma3-1b-smoke.golden.npz``, the same golden of the reduced
config, which is the one tier-1 re-derives (a full-width reference run
takes gigabytes and minutes, so tier-1 checks only the full golden's
record and the reduced golden's freshness).  The same mode writes both
goldens of the LMs of every other block kind the card serves,
``NEW_LM_NAMES`` (recurrentgemma-2b, granite-moe-1b-a400m, mamba2-780m,
whisper-tiny; whisper's prompts attend to ``lm_memory(cfg, 0, 1)``),
from the reference at full width and at reduced width; tier-1 re-derives
the reduced ones.  An MoE config's golden also holds the reference's
routing of every position at every MoE layer (``"routes"``, as
``cases.route_codes``), read out of its run by
``test_torch_moe.reference_routes``.  A full-width tree is held once:
each numpy leaf is dropped as it becomes a jax array.  Names after
``--lm`` write those configs' goldens alone:

    PYTHONPATH=src python tests/test_torch_assets.py --lm mamba2-780m

And one train golden, written only by the ``--train`` mode, never by
pytest:

    PYTHONPATH=src python tests/test_torch_assets.py --train [NAME]

``gemma3-1b.train.npz`` is the reference's ``make_train_step`` (its
default remat, jitted, the state donated) at full width and depth from
``lm_params(cfg, 0)``: ``cases.TRAIN_GOLDEN_STEPS`` steps on
``synthetic_batch`` at ``cases.TRAIN_GOLDEN_BATCH`` x
``TRAIN_GOLDEN_SEQ`` with ``AdamWConfig(**cases.TRAIN_GOLDEN_OPT)``:
each step's batch, loss, grad_norm and lr, each step's update (its
norm, and its dot with the new mu over mu's norm:
``cases.update_records``), the L2 norm of step 0's gradient of every
params leaf (``jax.value_and_grad`` of the loss the step
differentiates) and step 0's update records of every leaf, in the
reference's leaf order, with the optimizer's fields, the seed and the
recipe version.  The same mode
writes ``gemma3-1b-smoke.train.npz``, the same golden of the reduced
config, which tier-1 re-derives and holds the port to.
"""
import dataclasses
import hashlib
import json
import pathlib
import sys
import resource
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.analysis import verify_program
from repro.compile import artifact as ref_artifact
from repro.compile.driver import CompiledNet as RefCompiledNet
from repro.compile.targets import get_target
from repro.configs import get_config
from repro.core.executors import run_program
from repro.core.program import (AvgPoolSpec, ConvStreamSpec, GRUCellSpec,
                                plan_program)
from repro.graph.ir import Tensor, build_mlp_tower
from repro.graph.run import _quantize_net
from repro.quant import QParams, dequantize, quantize
from repro.models.registry import build_model as ref_build_model
from repro.serve.engine import ServingEngine as RefEngine
from repro.train import optimizer as ref_opt
from repro.train.data import synthetic_batch as ref_synthetic_batch
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch import load as port_load
from repro_torch.compile.artifact import (read_compile_inputs, to_device,
                                          write_compile_inputs)
from repro_torch.configs import get_config as port_get_config
from repro_torch.core.executors import run_program as port_run_program
from repro_torch.kernels.cases import (ATOL_REL, INT8_TARGETS,
                                       LM_GOLDEN_CACHE_LEN, LM_GOLDEN_STEPS,
                                       LM_GOLDEN_TOP, LM_PARAMS_VERSION,
                                       RTOL, SLICED_SUFFIX,
                                       TRAIN_GOLDEN_BATCH,
                                       TRAIN_GOLDEN_FLOATS, TRAIN_GOLDEN_OPT,
                                       TRAIN_GOLDEN_SEQ, TRAIN_GOLDEN_STEPS,
                                       compare_f32, hold_lm_golden,
                                       hold_train_golden, int8_stem,
                                       lm_memory, lm_params, lm_prompts,
                                       mlp_tower_params, program_live_lanes,
                                       route_codes, update_records)
from repro_torch.models import build_model, params_from_reference
from repro_torch.quant.qtensor import QParams as PortQParams
from repro_torch.quant.qtensor import quantize as port_quantize
from repro_torch.train import synthetic_batch as port_synthetic_batch
from repro_torch.train.tree import leaves_with_paths
from test_torch_moe import reference_routes, routing_of

ASSETS = (pathlib.Path(__file__).resolve().parents[1] / "src"
          / "repro_torch" / "assets")
NETS = ("ds-cnn", "resnet-8", "mcunet-5fps-vww", "ad-toyadmos")
FLOAT_TARGET = "host-sim"
FLOAT_NETS = ("ds-cnn", "resnet-8", "mcunet-5fps-vww", "ad-toyadmos")
STREAMS = ("ds-cnn-stream", "kws-gru-chain")
FLOAT_STREAMS = STREAMS
SEEDED_FLOAT_NETS = ("whisper-tiny-mlp",)
#: Seed of ``mlp_tower_params`` for the seeded plans' weights.
PARAMS_SEED = 0
#: Rows of a seeded net's output that its golden holds.
GOLDEN_ROWS = np.r_[0:64, 1436:1500]
N_INPUTS, N_FRAMES, N_SEEDED_INPUTS = 8, 60, 2
#: Keys of a saved artifact that vary from compile to compile (timings).
TIMED = ("passes", "spans")
#: The net whose reference compile inputs are committed.
COMPILE_NET = "ds-cnn"
#: The net served as a sliced (partial-execution) int8 plan, and the
#: number of its golden inputs.
SLICED_NET = "mcunet-320kb-imagenet"
N_SLICED_INPUTS = 2


def artifact_path(name: str) -> pathlib.Path:
    return ASSETS / f"{int8_stem(name)}.json"


def golden_path(name: str) -> pathlib.Path:
    return ASSETS / f"{int8_stem(name)}.golden.npz"


def float_artifact_path(name: str) -> pathlib.Path:
    return ASSETS / f"{name}.{FLOAT_TARGET}.float32.json"


def float_golden_path(name: str) -> pathlib.Path:
    return ASSETS / f"{name}.{FLOAT_TARGET}.float32.golden.npz"


def sliced_artifact_path() -> pathlib.Path:
    return artifact_path(SLICED_NET + SLICED_SUFFIX)


def sliced_golden_path() -> pathlib.Path:
    return golden_path(SLICED_NET + SLICED_SUFFIX)


def compile_sliced_reference(quantize: bool = True) -> RefCompiledNet:
    """The reference's sliced ImageNet compile for the M4 (planner-only
    when not ``quantize``)."""
    return repro.compile(SLICED_NET, INT8_TARGETS[SLICED_NET + SLICED_SUFFIX],
                         dtype="int8", partial="auto",
                         certify="static", quantize=quantize)


def compile_inputs_path() -> pathlib.Path:
    return ASSETS / f"{int8_stem(COMPILE_NET)}.compile.npz"


def reference_compile_inputs(cn: RefCompiledNet) -> tuple[list, np.ndarray]:
    """The float params of the reference's default int8 compile ``cn``
    (``init_net_params`` from ``PRNGKey(0)``) and the calibration inputs
    its ``_quantize_net`` drew (``n_calib=2`` normals from
    ``PRNGKey(0)``), as numpy arrays."""
    prog = cn.plan.program
    calib = np.asarray(jax.random.normal(
        jax.random.PRNGKey(0), (2, prog.in_rows, prog.in_dim)))
    params = [None if p is None else
              tuple(None if a is None else np.asarray(a) for a in p)
              for p in cn.params]
    return params, calib


def _chain_params():
    """``tests/test_stream.py::_chain_params`` at the chain's widths."""
    k1, k2, k3, k4, k5 = jax.random.split(jax.random.PRNGKey(7), 5)
    w = jax.random.normal(k1, (5, 5, 1, 64)) / 25 ** 0.5
    b = jax.random.normal(k2, (64,)) / 8
    wg = jax.random.normal(k3, (64, 192)) / 64 ** 0.5
    ug = jax.random.normal(k4, (64, 192)) / 64 ** 0.5
    bg = jax.random.normal(k5, (192,)) / 8
    return [(w, b), None, (wg, ug, bg)]


def _gru_chain(quantize: bool = True) -> RefCompiledNet:
    """The keyword-spotting GRU chain as a reference ``CompiledNet``:
    calibrated int8 for ``cortex-m4``, or left in fp32 for ``host-sim``."""
    prog = plan_program(10, 1, [
        ConvStreamSpec(49, 10, 1, 64, k=5, stride=2, hop=1,
                       activation="relu"),
        AvgPoolSpec(25, 5, 64), GRUCellSpec(64)], block_rows=1)
    params = _chain_params()
    qnet = _quantize_net(prog, params) if quantize else None
    prog = qnet.program if quantize else prog
    cert = verify_program(prog).certificate(
        ref_artifact.program_sha256(prog))
    return RefCompiledNet(
        net_name="kws-gru-chain",
        target=get_target(INT8_TARGETS["kws-gru-chain"] if quantize
                          else FLOAT_TARGET),
        dtype="int8" if quantize else "float32", program=prog,
        params=params, qnet=qnet, mcu={}, certificate=cert, passes=[])


def compile_reference(name: str) -> RefCompiledNet:
    if name == "kws-gru-chain":
        return _gru_chain()
    if name == "ds-cnn-stream":
        return repro.compile("ds-cnn", INT8_TARGETS[name], streaming=True)
    return repro.compile(name, INT8_TARGETS[name])


def _mlp_tower(seed: int = PARAMS_SEED) -> RefCompiledNet:
    """whisper-tiny's MLP tower over its 1,500 encoder rows, one
    elementwise gelu after the last layer, compiled for ``host-sim`` with
    the seeded weights."""
    cfg = get_config("whisper-tiny")
    g = build_mlp_tower(cfg, m_rows=cfg.encoder_seq, elem_bytes=4)
    g.add("gelu", "elementwise", [f"L{cfg.n_layers - 1}.mlp"],
          Tensor(rows=cfg.encoder_seq, d=cfg.d_model, elem_bytes=4),
          activation="gelu")
    g.validate()
    params = mlp_tower_params(repro.compile(g, FLOAT_TARGET).program, seed)
    return repro.compile(g, FLOAT_TARGET, params=params)


def compile_float_reference(name: str) -> RefCompiledNet:
    """The reference's fp32 ``host-sim`` compile of a net or stream."""
    if name == "whisper-tiny-mlp":
        return _mlp_tower()
    if name == "kws-gru-chain":
        return _gru_chain(quantize=False)
    if name == "ds-cnn-stream":
        return repro.compile("ds-cnn", FLOAT_TARGET, streaming=True)
    return repro.compile(name, FLOAT_TARGET)


def artifact_payload(cn: RefCompiledNet, *, params: bool = False) -> dict:
    """What ``cn.save`` writes, without the fp32 ``params`` unless
    ``params``."""
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "a.json"
        cn.save(str(path))
        payload = json.loads(path.read_text())
    if not params:
        del payload["params"]
    return payload


def float_payload(name: str, cn: RefCompiledNet) -> dict:
    """What an fp32 asset holds: ``cn.save``'s payload, with its fp32
    ``params`` but for a seeded plan, which keeps ``"params": null``."""
    if name not in SEEDED_FLOAT_NETS:
        return artifact_payload(cn, params=True)
    blank = dataclasses.replace(cn, params=[None] * len(cn.program.ops))
    return dict(artifact_payload(blank, params=True), params=None)


def golden_inputs(program, n: int) -> np.ndarray:
    return np.random.default_rng(0).standard_normal(
        (n, program.ops[0].rows_in or program.in_rows, program.in_dim),
        np.float32)


def _sha(pool) -> str:
    return hashlib.sha256(np.asarray(pool.array).tobytes()).hexdigest()


def net_golden(cn: RefCompiledNet, n: int = N_INPUTS) -> dict:
    """The reference's float outputs (``run(x, backend="jnp")`` on the
    batch), int8 outputs and final-pool sha256 per input."""
    x = golden_inputs(cn.program, n)
    y = np.asarray(cn.run(x, backend="jnp"))
    qn = cn.qnet
    y_q, shas = [], []
    for xi in x:
        yq, pool = run_program(qn.program,
                               quantize(xi, QParams(scale=qn.in_scale)),
                               qn.qparams, backend="jnp")
        y_q.append(np.asarray(yq))
        shas.append(_sha(pool))
    return {"x": x, "y": y, "y_q": np.stack(y_q),
            "pool_sha256": np.array(shas)}


def stream_golden(cn: RefCompiledNet) -> dict:
    """The reference session's int8 output of every step, from frames
    quantized at the input scale, their dequantized float outputs, and
    the pool's sha256 after the last step."""
    qn = cn.qnet
    x = golden_inputs(cn.program, N_FRAMES)
    x_q = np.asarray(quantize(x, QParams(scale=qn.in_scale)))
    session = cn.stream(backend="jnp")
    y_q = np.stack([np.asarray(session.step(f)) for f in x_q])
    y = np.asarray(dequantize(y_q, QParams(scale=qn.out_scale)))
    return {"x": x, "x_q": x_q, "y_q": y_q, "y": y,
            "pool_sha256": np.array(_sha(session._pool))}


def reference_golden(name: str, cn: RefCompiledNet) -> dict:
    return stream_golden(cn) if name in STREAMS else net_golden(cn)


def float_golden(name: str, cn: RefCompiledNet) -> dict:
    """A net's 8 seeded inputs and the reference's Pallas outputs for
    them (one batched ``run``), or a stream's 60 seeded frames and the
    reference session's output of each step."""
    if name in SEEDED_FLOAT_NETS:
        x = golden_inputs(cn.program, N_SEEDED_INPUTS)
        y = np.asarray(cn.run(x, backend="jnp"))
        return {"x_sha256": np.array(hashlib.sha256(x.tobytes()).hexdigest()),
                "rows": GOLDEN_ROWS, "y": y[:, GOLDEN_ROWS]}
    if name in FLOAT_STREAMS:
        x = golden_inputs(cn.program, N_FRAMES)
        session = cn.stream(backend="jnp")
        return {"x": x, "y": np.stack([np.asarray(session.step(f))
                                       for f in x])}
    x = golden_inputs(cn.program, N_INPUTS)
    return {"x": x, "y": np.asarray(cn.run(x, backend="pallas"))}


def write_assets(names=NETS + STREAMS,
                 float_names=FLOAT_NETS + FLOAT_STREAMS
                 + SEEDED_FLOAT_NETS) -> None:
    ASSETS.mkdir(parents=True, exist_ok=True)
    for name in names:
        cn = compile_reference(name)
        artifact_path(name).write_text(json.dumps(artifact_payload(cn)))
        np.savez(golden_path(name), **reference_golden(name, cn))
        if name == COMPILE_NET:
            write_compile_inputs(compile_inputs_path(),
                                 *reference_compile_inputs(cn))
    for name in float_names:
        cn = compile_float_reference(name)
        float_artifact_path(name).write_text(
            json.dumps(float_payload(name, cn)))
        np.savez(float_golden_path(name), **float_golden(name, cn))
    write_sliced_asset()
    write_zoo_assets()


def write_sliced_asset() -> None:
    cn = compile_sliced_reference()
    sliced_artifact_path().write_text(json.dumps(artifact_payload(cn)))
    np.savez(sliced_golden_path(), **net_golden(cn, N_SLICED_INPUTS))


#: The zoo nets of the main path whose assets the per-net test files
#: hold (``tests/test_torch_mobilenet.py``,
#: ``tests/test_torch_imagenet_m7.py``), each compiling the reference's
#: plans once: int8 for the net's target in ``INT8_TARGETS``, fp32 for
#: ``host-sim``.  Each golden holds ``N_ZOO_INPUTS`` seeded inputs and
#: the reference's ``run(x, backend="jnp")`` outputs (and, int8, the
#: int8 outputs and final-pool sha256).
ZOO_NETS = ("mobilenetv1-0.25", "mcunet-320kb-imagenet")
N_ZOO_INPUTS = 2


def zoo_float_golden(cn: RefCompiledNet) -> dict:
    x = golden_inputs(cn.program, N_ZOO_INPUTS)
    return {"x": x, "y": np.asarray(cn.run(x, backend="jnp"))}


def write_zoo_assets(names=ZOO_NETS) -> None:
    for name in names:
        for quantized in (True, False):
            t0 = time.perf_counter()
            if quantized:
                cn = compile_reference(name)
                artifact_path(name).write_text(
                    json.dumps(artifact_payload(cn)))
            else:
                cn = compile_float_reference(name)
                float_artifact_path(name).write_text(
                    json.dumps(float_payload(name, cn)))
            t1 = time.perf_counter()
            if quantized:
                np.savez(golden_path(name), **net_golden(cn, N_ZOO_INPUTS))
            else:
                np.savez(float_golden_path(name), **zoo_float_golden(cn))
            print(f"wrote {name} {cn.dtype} ({cn.target.name}): compile "
                  f"{t1 - t0:.1f} s, golden {time.perf_counter() - t1:.1f} s",
                  flush=True)


def hold_fresh_zoo_assets(name: str, ref_q: RefCompiledNet,
                          ref_f: RefCompiledNet) -> None:
    """A zoo net's four assets are a fresh reference compile's (``ref_q``
    int8, ``ref_f`` fp32) and its fresh run's: the artifacts but their
    timings, the goldens' inputs bitwise, the int8 outputs, float outputs
    and pool hashes bitwise, the fp32 outputs to the fp32 tolerance (a
    golden written in another process)."""
    for have, want in ((json.loads(artifact_path(name).read_text()),
                        artifact_payload(ref_q)),
                       (json.loads(float_artifact_path(name).read_text()),
                        float_payload(name, ref_f))):
        assert sorted(have) == sorted(want)
        for key in sorted(set(want) - set(TIMED)):
            assert have[key] == want[key], key
    assert "params" not in json.loads(artifact_path(name).read_text())
    want = net_golden(ref_q, N_ZOO_INPUTS)
    with np.load(golden_path(name)) as have:
        assert sorted(have.files) == sorted(want)
        for key, arr in want.items():
            np.testing.assert_array_equal(have[key], arr, err_msg=key)
    want = zoo_float_golden(ref_f)
    with np.load(float_golden_path(name)) as have:
        assert sorted(have.files) == ["x", "y"]
        np.testing.assert_array_equal(have["x"], want["x"])
        scale = float(np.abs(want["y"]).max())
        np.testing.assert_allclose(have["y"], want["y"], rtol=3e-4,
                                   atol=3e-5 * scale)
    assert want["y"].shape[0] == N_ZOO_INPUTS
    assert np.isfinite(want["y"]).all()


def hold_port_zoo_int8(name: str) -> None:
    """The port's plain path on the int8 asset, on the CPU: ``run``'s
    float outputs, each input's int8 outputs and final-pool sha256 equal
    the golden (the reference's ``jnp`` run) bit for bit."""
    cn = port_load(artifact_path(name))
    with np.load(golden_path(name)) as g:
        golden = {k: g[k] for k in g.files}
    y = cn.run(golden["x"], device="cpu")
    assert y.device.type == "cpu" and np.array_equal(y.numpy(), golden["y"])
    qparams = to_device(cn.qnet.qparams, "cpu")
    for i, xi in enumerate(torch.from_numpy(golden["x"])):
        y_q, pool = port_run_program(
            cn.program, port_quantize(xi, PortQParams(
                scale=cn.qnet.in_scale)), qparams,
            kernel_block_rows=cn.target.kernel_block_rows)
        assert np.array_equal(y_q.numpy(), golden["y_q"][i]), i
        assert hashlib.sha256(pool.array.numpy().tobytes()).hexdigest() \
            == golden["pool_sha256"][i], i


def hold_port_zoo_float(name: str, ref_f: RefCompiledNet) -> None:
    """The port's plain path on the fp32 asset, on the CPU: ``run``'s
    outputs within the fp32 tolerance of the golden, and each input's
    final pool within it of the reference's ``jnp`` pool on the live
    channels, exactly equal on channel tails and unwritten lanes (which
    hold 0)."""
    cn = port_load(float_artifact_path(name))
    with np.load(float_golden_path(name)) as g:
        x, want = g["x"], g["y"]
    y = cn.run(x, device="cpu").numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(y, want, rtol=RTOL, atol=ATOL_REL * scale)
    kbr = cn.target.kernel_block_rows
    params = to_device(cn.params, "cpu")
    live = program_live_lanes(cn.program, cn.params, kernel_block_rows=kbr)
    for xi in x:
        _, pool_ref = run_program(ref_f.program, jnp.asarray(xi),
                                  ref_f.params, backend="jnp")
        _, pool = port_run_program(cn.program, torch.from_numpy(xi), params,
                                   kernel_block_rows=kbr)
        got = pool.array.numpy()
        _, bad = compare_f32(got, np.asarray(pool_ref.array), live)
        assert bad is None, bad
        assert not got[~live].any()


def op_kinds(cn) -> dict[str, int]:
    kinds = [op.kind for op in cn.program.ops]
    return {k: kinds.count(k) for k in sorted(set(kinds))}


@pytest.fixture(scope="module")
def fresh():
    """A fresh reference compile of every asset, made once."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = compile_reference(name)
        return cache[name]
    return get


@pytest.mark.parametrize("name", NETS + STREAMS)
def test_artifact_matches_a_fresh_compile(name, fresh):
    have = json.loads(artifact_path(name).read_text())
    want = artifact_payload(fresh(name))
    assert "params" not in have
    assert sorted(have) == sorted(want)
    for key in sorted(set(want) - set(TIMED)):
        assert have[key] == want[key], key


@pytest.mark.parametrize("name", NETS + STREAMS)
def test_golden_matches_a_fresh_reference_run(name, fresh):
    want = reference_golden(name, fresh(name))
    with np.load(golden_path(name)) as have:
        assert sorted(have.files) == sorted(want)
        for key, arr in want.items():
            np.testing.assert_array_equal(have[key], arr, err_msg=key)
    n = N_FRAMES if name in STREAMS else N_INPUTS
    # the float golden is the dequantized int8 golden
    assert want["y"].shape == want["y_q"].shape
    assert want["y"].shape[0] == n


@pytest.fixture(scope="module")
def fresh_float():
    """A fresh reference ``host-sim`` compile of every fp32 asset, and
    its golden, each made once."""
    cache = {}

    def get(name):
        if name not in cache:
            cn = compile_float_reference(name)
            cache[name] = cn, float_golden(name, cn)
        return cache[name]
    return get


@pytest.mark.parametrize("name", FLOAT_NETS + FLOAT_STREAMS
                         + SEEDED_FLOAT_NETS)
def test_float_artifact_matches_a_fresh_compile(name, fresh_float):
    have = json.loads(float_artifact_path(name).read_text())
    want = float_payload(name, fresh_float(name)[0])
    assert have["dtype"] == "float32" and have["quant"] is None
    assert sorted(have) == sorted(want)
    for key in sorted(set(want) - set(TIMED)):
        assert have[key] == want[key], key


@pytest.mark.parametrize("name", FLOAT_NETS + FLOAT_STREAMS
                         + SEEDED_FLOAT_NETS)
def test_float_golden_matches_a_fresh_reference_run(name, fresh_float):
    """The inputs (or a seeded plan's inputs' sha256 and its golden rows)
    are the seeded ones and the outputs the reference's outputs for them
    (to the fp32 tolerance: the golden was written in another
    process)."""
    want = fresh_float(name)[1]
    with np.load(float_golden_path(name)) as have:
        assert sorted(have.files) == sorted(want)
        for key in sorted(set(want) - {"y"}):
            np.testing.assert_array_equal(have[key], want[key], err_msg=key)
        scale = float(np.abs(want["y"]).max())
        np.testing.assert_allclose(have["y"], want["y"], rtol=3e-4,
                                   atol=3e-5 * scale)
    n = N_FRAMES if name in FLOAT_STREAMS else N_SEEDED_INPUTS \
        if name in SEEDED_FLOAT_NETS else N_INPUTS
    assert want["y"].shape[0] == n and np.isfinite(want["y"]).all()


def test_the_mlp_tower_asset_is_whisper_tiny_at_full_width(fresh_float):
    """Four in-place fused MLPs at d_model 384 and d_ff 1536 over 1,500
    rows, then the elementwise gelu, on a 4,500-segment ring; 18.9 MB of
    seeded weights that the artifact does not hold."""
    cn = fresh_float("whisper-tiny-mlp")[0]
    prog = cn.program
    assert [op.kind for op in prog.ops] == ["fused_mlp"] * 4 \
        + ["elementwise"]
    assert prog.n_segments == 4500 and prog.m_rows == 1500
    for op in prog.ops[:4]:
        assert (op.d_in, op.d_ff, op.ff_tile, op.gated, op.residual,
                op.activation, op.in_ptr, op.out_ptr) == \
            (384, 1536, 512, False, True, "gelu", 0, 0)
    assert prog.ops[4].activation == "gelu"
    assert cn.flash_bytes_used == 18_874_368
    have = json.loads(float_artifact_path("whisper-tiny-mlp").read_text())
    assert have["params"] is None


def test_float_assets_reach_the_three_kernels_of_their_paths(fresh_float):
    """fp32 VWW runs six fused inverted bottlenecks and both fp32 streams
    hold their state in the ring; the DS-CNN window is 490 segments."""
    kinds = [op.kind for op in fresh_float("mcunet-5fps-vww")[0].program.ops]
    assert len(kinds) == 21 and kinds.count("ib_fused") == 6
    for name in FLOAT_STREAMS:
        cn = fresh_float(name)[0]
        assert not cn.quantized and cn.dtype == "float32"
        assert cn.target.name == FLOAT_TARGET
        assert cn.certificate["stream_horizon"] == "unbounded"
    chain = {op.kind for op in fresh_float("kws-gru-chain")[0].program.ops}
    assert chain == {"conv_stream", "pool_avg", "gru_cell"}
    win = fresh_float("ds-cnn-stream")[0].program.ops[0]
    assert win.kind == "conv_stream" and win.state_segments == 490


def test_stream_assets_hold_state_and_every_stream_kind(fresh):
    kinds = {op.kind for name in STREAMS
             for op in fresh(name).program.ops}
    assert {"conv_stream", "gru_cell"} <= kinds
    chain = fresh("kws-gru-chain")
    assert chain.certificate["stream_horizon"] == "unbounded"
    assert chain.qnet.out_scale == 1.0 / 128.0    # the fixed Q7 state
    win = fresh("ds-cnn-stream").program.ops[0]
    assert win.state_segments * 128 == 62_720     # 49 x 10 x 1 window


def test_compile_inputs_are_the_reference_default_draws(fresh):
    """The committed compile inputs are a fresh reference compile's
    params and calibration draws, bit for bit, and they are what its
    ``quantize`` pass used: calibrating on them gives its scales."""
    cn = fresh(COMPILE_NET)
    have_p, have_c = read_compile_inputs(compile_inputs_path())
    want_p, want_c = reference_compile_inputs(cn)
    np.testing.assert_array_equal(have_c, want_c)
    assert have_c.dtype == np.float32 and have_c.shape[0] == 2
    assert len(have_p) == len(want_p) == len(cn.program.ops)
    for i, (h, w) in enumerate(zip(have_p, want_p)):
        assert (h is None) == (w is None), i
        if w is None:
            continue
        assert len(h) == len(w), i
        for a, b in zip(h, w):
            assert (a is None) == (b is None), i
            if b is not None:
                assert a.dtype == b.dtype, i
                np.testing.assert_array_equal(a, b, err_msg=str(i))
    q = _quantize_net(cn.plan, have_p, calib=have_c)
    assert q.act_scales == cn.qnet.act_scales


def test_the_sliced_asset_is_a_fresh_partial_compile():
    """The sliced artifact's plan (program, certificate, ``mcu`` and
    ``partial``) is a fresh planner-only compile's: 36 slices bring the
    deployable ring from 196,416 to 125,312 B, 158 ops (pw 98, dw 48,
    add 10, pool, gemm), 31 of them reading a window of a held source."""
    have = json.loads(sliced_artifact_path().read_text())
    want = artifact_payload(compile_sliced_reference(quantize=False))
    assert "params" not in have and have["quant"] is not None
    for key in ("program", "certificate", "mcu", "partial", "target",
                "dtype", "net"):
        assert have[key] == want[key], key
    s = have["partial"]
    assert (s["n_sliced_groups"], s["total_slices"], s["ring_bytes_before"],
            s["ring_bytes_after"]) == (5, 36, 196_416, 125_312)
    ops = have["program"]["ops"]
    kinds = [op["kind"] for op in ops]
    assert len(ops) == 158 and {k: kinds.count(k) for k in set(kinds)} == \
        {"conv_pw": 98, "conv_dw": 48, "add": 10, "pool_avg": 1, "gemm": 1}
    assert sum(op["in_row0"] > 0 for op in ops) == 31
    assert sum(op["out_op"] >= 0 for op in ops) == 36
    with np.load(sliced_golden_path()) as g:
        assert sorted(g.files) == ["pool_sha256", "x", "y", "y_q"]
        np.testing.assert_array_equal(
            g["x"], golden_inputs(compile_sliced_reference(quantize=False)
                                  .program, N_SLICED_INPUTS))
        assert g["y"].shape == (N_SLICED_INPUTS, 1, 1000)


# ---------------------------------------------------------------------------
# The LM golden.
# ---------------------------------------------------------------------------

#: The LM whose golden is committed, at full width and reduced.
LM_NAME = "gemma3-1b"
#: The LMs of the other block kinds, whose goldens (full width and
#: reduced) are committed too.
NEW_LM_NAMES = ("recurrentgemma-2b", "granite-moe-1b-a400m", "mamba2-780m",
                "whisper-tiny")


def lm_golden_path(cfg) -> pathlib.Path:
    return ASSETS / f"{cfg.name}.golden.npz"


def _to_jax(tree):
    """``tree`` with its numpy leaves as jax arrays, converted in place
    where the tree is a dict, so that each numpy leaf is dropped once
    copied: a full-width tree is held once, not twice."""
    if isinstance(tree, dict):
        for key in list(tree):
            tree[key] = _to_jax(tree[key])
        return tree
    if isinstance(tree, tuple):
        return tuple(_to_jax(v) for v in tree)
    return jnp.asarray(tree)


def lm_golden(cfg, seed: int = PARAMS_SEED) -> dict:
    """The reference's greedy steps on ``lm_prompts``: per prompt, at
    batch 1 through the reference ``ServingEngine``'s jitted prefill and
    decode step (what its ``generate`` runs), each step's token (the
    argmax), top-``LM_GOLDEN_TOP`` logits and ids and max |logit|; for
    an MoE config, every position's routing at every MoE layer
    (``"routes"``, ``[prompts, layers, max prompt + steps - 1, k]``: the
    prompt's positions, then one a decode step; ``n_experts`` past a
    prompt's own)."""
    model = ref_build_model(cfg)
    moe_layers = cfg.n_layers - cfg.first_dense_layers if cfg.n_experts \
        else 0
    prompts = lm_prompts(cfg.vocab, seed)
    memory = lm_memory(cfg, seed, 1)
    memory = None if memory is None else jnp.asarray(memory)
    L = max(len(p) for p in prompts)
    out = {"prompts": np.zeros((len(prompts), L), np.int32),
           "prompt_lens": np.asarray([len(p) for p in prompts], np.int32),
           "tokens": np.zeros((len(prompts), LM_GOLDEN_STEPS), np.int32),
           "top_ids": np.zeros((len(prompts), LM_GOLDEN_STEPS,
                                LM_GOLDEN_TOP), np.int32),
           "top_logits": np.zeros((len(prompts), LM_GOLDEN_STEPS,
                                   LM_GOLDEN_TOP), np.float32),
           "absmax": np.zeros((len(prompts), LM_GOLDEN_STEPS), np.float32),
           "seed": np.int32(seed), "recipe_version":
           np.int32(LM_PARAMS_VERSION), "config": np.str_(cfg.name),
           "cache_len": np.int32(LM_GOLDEN_CACHE_LEN)}
    if moe_layers:
        out["routes"] = np.full((len(prompts), moe_layers,
                                 L + LM_GOLDEN_STEPS - 1, cfg.top_k),
                                cfg.n_experts, np.int32)
    with reference_routes(cfg) as calls:
        tree = _to_jax(lm_params(cfg, seed))
        engine = RefEngine(model, tree, cache_len=LM_GOLDEN_CACHE_LEN)
        for i, prompt in enumerate(prompts):
            n = len(prompt)
            out["prompts"][i, :n] = prompt
            logits, caches, cur = engine.prefill(
                tree, jnp.asarray([prompt], jnp.int32), memory)
            for t in range(LM_GOLDEN_STEPS):
                if t:
                    logits, caches, cur = engine.decode(
                        tree, caches,
                        jnp.asarray(out["tokens"][i, t - 1:t]), cur)
                vals, ids = jax.lax.top_k(logits[0], LM_GOLDEN_TOP)
                out["top_logits"][i, t] = np.asarray(vals)
                out["top_ids"][i, t] = np.asarray(ids)
                out["tokens"][i, t] = int(jnp.argmax(logits[0]))
                out["absmax"][i, t] = float(jnp.abs(logits[0]).max())
                jax.effects_barrier()
                if moe_layers:
                    assert len(calls) == moe_layers, (len(calls), t)
                    at = slice(0, n) if t == 0 else slice(n + t - 1, n + t)
                    out["routes"][i, :, at] = route_codes(
                        [routing_of(c, 1, cfg) for c in calls])[:, 0]
                calls.clear()
    return out


def write_lm_goldens(names=()) -> None:
    """Both goldens of gemma3-1b and of each ``NEW_LM_NAMES`` config, or
    of ``names`` alone."""
    for name in names or (LM_NAME,) + NEW_LM_NAMES:
        for cfg in (get_config(name), get_config(name).reduced()):
            np.savez(lm_golden_path(cfg), **lm_golden(cfg))
            print(f"wrote {lm_golden_path(cfg)}", flush=True)


@pytest.fixture(scope="module")
def lm_smoke_golden():
    """A fresh reference run of the reduced LM golden."""
    return lm_golden(get_config(LM_NAME).reduced())


def test_lm_golden_matches_a_fresh_reference_run(lm_smoke_golden):
    """The reduced golden is the reference's greedy run on the recipe's
    weights: the same prompts, tokens and top ids, logits to the fp32
    tolerance of a golden written in another process."""
    _same_lm_golden(get_config(LM_NAME).reduced(), lm_smoke_golden)


@pytest.mark.parametrize("name", NEW_LM_NAMES)
def test_new_kind_lm_goldens_match_a_fresh_reference_run(name):
    """The reduced golden of each other block kind is the reference's
    greedy run, as gemma3-1b's is."""
    cfg = get_config(name).reduced()
    _same_lm_golden(cfg, lm_golden(cfg))


def _same_lm_golden(cfg, want) -> None:
    tol = 3e-5 * float(want["absmax"].max())
    with np.load(lm_golden_path(cfg)) as have:
        assert sorted(have.files) == sorted(want)
        for key in sorted(set(want) - {"top_logits", "absmax", "top_ids"}):
            np.testing.assert_array_equal(have[key], want[key], err_msg=key)
        for key in ("top_logits", "absmax"):
            np.testing.assert_allclose(have[key], want[key], rtol=3e-4,
                                       atol=tol)
        # ids agree but where two logits within the tolerance swap places
        # (or the 64th place goes to a near tie outside the list)
        logits = want["top_logits"]
        for at in zip(*np.nonzero(have["top_ids"] != want["top_ids"])):
            *step, k = at
            near = [abs(logits[(*step, k)] - logits[(*step, n)]) <= tol
                    for n in (k - 1, k + 1) if 0 <= n < logits.shape[-1]]
            assert any(near) or k == logits.shape[-1] - 1, at
    assert (want["tokens"] == want["top_ids"][..., 0]).all()


def test_the_full_width_lm_golden_is_the_recipe_of_record():
    """The committed full-width golden was written from ``lm_params`` of
    the current recipe version and seed for gemma3-1b, on the prompts
    ``lm_prompts`` draws, and is small."""
    cfg = get_config(LM_NAME)
    path = lm_golden_path(cfg)
    assert path.stat().st_size < 1 << 20
    with np.load(path) as g:
        assert str(g["config"]) == "gemma3-1b" == cfg.name
        assert int(g["seed"]) == PARAMS_SEED
        assert int(g["recipe_version"]) == LM_PARAMS_VERSION
        assert int(g["cache_len"]) == LM_GOLDEN_CACHE_LEN
        prompts = lm_prompts(cfg.vocab, PARAMS_SEED)
        assert list(g["prompt_lens"]) == [8, 24]
        for i, p in enumerate(prompts):
            assert list(g["prompts"][i, :len(p)]) == p
        assert g["tokens"].shape == (2, LM_GOLDEN_STEPS)
        assert g["top_ids"].shape == g["top_logits"].shape \
            == (2, LM_GOLDEN_STEPS, LM_GOLDEN_TOP)
        assert (g["tokens"] == g["top_ids"][..., 0]).all()
        assert ((g["top_ids"] >= 0) & (g["top_ids"] < cfg.vocab)).all()
        assert np.isfinite(g["top_logits"]).all()


@pytest.mark.parametrize("name", NEW_LM_NAMES)
def test_the_full_width_new_kind_lm_goldens_are_the_recipe_of_record(name):
    """The committed full-width goldens of the other block kinds hold
    the reference's run, laid out as gemma3-1b's (plus the routing of an
    MoE config), from ``lm_params`` of the current recipe version and
    seed, on ``lm_prompts``' prompts (and ``lm_memory``'s frames), and
    are small."""
    cfg = port_get_config(name)
    path = lm_golden_path(cfg)
    assert path.stat().st_size < 1 << 20
    with np.load(lm_golden_path(get_config(LM_NAME))) as g:
        keys = set(g.files) | ({"routes"} if cfg.n_experts else set())
    with np.load(path) as g:
        assert set(g.files) == keys
        assert str(g["config"]) == name
        if cfg.n_experts:
            moe_layers = cfg.n_layers - cfg.first_dense_layers
            assert g["routes"].shape == (2, moe_layers, 24 + LM_GOLDEN_STEPS
                                         - 1, cfg.top_k)
            assert ((g["routes"] >= -cfg.n_experts)
                    & (g["routes"] <= cfg.n_experts)).all()
        assert int(g["seed"]) == PARAMS_SEED
        assert int(g["recipe_version"]) == LM_PARAMS_VERSION
        assert int(g["cache_len"]) == LM_GOLDEN_CACHE_LEN
        prompts = lm_prompts(cfg.vocab, PARAMS_SEED)
        assert list(g["prompt_lens"]) == [8, 24]
        for i, p in enumerate(prompts):
            assert list(g["prompts"][i, :len(p)]) == p
        assert g["tokens"].shape == (2, LM_GOLDEN_STEPS)
        assert g["top_ids"].shape == g["top_logits"].shape \
            == (2, LM_GOLDEN_STEPS, LM_GOLDEN_TOP)
        assert (g["tokens"] == g["top_ids"][..., 0]).all()
        assert ((g["top_ids"] >= 0) & (g["top_ids"] < cfg.vocab)).all()
        assert np.isfinite(g["top_logits"]).all()


@pytest.mark.parametrize("name", NEW_LM_NAMES)
def test_the_port_holds_the_new_kind_reduced_lm_goldens(name):
    """The port on the CPU holds each other kind's reduced golden as it
    holds gemma3-1b's."""
    cfg = port_get_config(name).reduced()
    params = params_from_reference(cfg, lm_params(cfg, PARAMS_SEED), "cpu")
    with np.load(lm_golden_path(cfg)) as g:
        held = hold_lm_golden(build_model(cfg), params, dict(g))
    assert held["ok"], held


def test_the_port_holds_the_reduced_lm_golden():
    """The port on the CPU, teacher-forced on the reduced golden's
    tokens: every step's logits at the golden's top ids within rtol 2e-2
    and atol 2e-2 * max|logits|, greedy tokens equal unless a near tie
    flips (the check ``chip_smoke.py`` makes at full width on the
    card)."""
    cfg = port_get_config(LM_NAME).reduced()
    params = params_from_reference(cfg, lm_params(cfg, PARAMS_SEED), "cpu")
    with np.load(lm_golden_path(cfg)) as g:
        held = hold_lm_golden(build_model(cfg), params, dict(g))
    assert held["ok"], held


# ---------------------------------------------------------------------------
# The train golden
# ---------------------------------------------------------------------------

def train_golden_path(cfg) -> pathlib.Path:
    return ASSETS / f"{cfg.name}.train.npz"


def _ref_key(path) -> str:
    return "|".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def train_golden(cfg, seed: int = PARAMS_SEED) -> dict:
    """The reference's first train steps, as the ``--train`` mode writes
    them (module docstring)."""
    model = ref_build_model(cfg)
    opt = ref_opt.AdamWConfig(**TRAIN_GOLDEN_OPT)
    B, S = TRAIN_GOLDEN_BATCH, TRAIN_GOLDEN_SEQ
    batches = [ref_synthetic_batch(cfg, B, S, i)
               for i in range(TRAIN_GOLDEN_STEPS)]
    out = {"config": np.str_(cfg.name), "seed": np.int32(seed),
           "recipe_version": np.int32(LM_PARAMS_VERSION),
           "batch": np.int32(B), "seq": np.int32(S),
           "tokens": np.stack([np.asarray(b["tokens"]) for b in batches]),
           "labels": np.stack([np.asarray(b["labels"]) for b in batches])}
    for f in dataclasses.fields(opt):
        out["opt_" + f.name] = np.asarray(getattr(opt, f.name))
    tree = _to_jax(lm_params(cfg, seed))
    out["leaf_keys"] = np.asarray(
        [_ref_key(p) for p, _ in jax.tree_util.tree_flatten_with_path(
            tree)[0]])

    def leaf_norms(params, batch):
        grads = jax.grad(lambda p: model.loss(p, batch)[0])(params)
        return jnp.stack([jnp.sqrt(jnp.sum(jnp.square(
            g.astype(jnp.float32)))) for g in jax.tree.leaves(grads)])
    out["leaf_norms"] = np.asarray(jax.jit(leaf_norms)(tree, batches[0]))
    train_step = ref_make_train_step(model, opt=opt)

    def step_with_sums(state, batch):
        """The step, and per leaf its update's sum of squares, the
        update's dot with the new mu and the new mu's sum of squares
        (``jnp.sum`` of the products: XLA's CPU ``vdot`` sums a long
        vector in one fp32 run a lane, and stalls near 2^24 terms)."""
        new, m = train_step(state, batch)
        d = [a - b for a, b in zip(jax.tree.leaves(new.params),
                                   jax.tree.leaves(state.params))]
        mu = jax.tree.leaves(new.mu)
        return new, m, [jnp.stack([jnp.sum(x * y) for x, y in pairs])
                        for pairs in (zip(d, d), zip(d, mu), zip(mu, mu))]
    step = jax.jit(step_with_sums, donate_argnums=(0,))
    state = ref_opt.init_state(tree)
    del tree
    rows, updates = [], []
    for b in batches:
        state, m, sums = step(state, b)
        rows.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
        updates.append(update_records(*(np.asarray(a) for a in sums)))
    for j, k in enumerate(("loss", "grad_norm", "lr")):
        out[k] = np.asarray([r[j] for r in rows], np.float32)
    for k in ("update_norm", "update_dot"):
        out[k] = np.asarray([u[k] for u in updates], np.float32)
    for k in ("leaf_update_dots", "leaf_mu_norms"):
        out[k] = np.asarray(updates[0][k], np.float32)
    return out


def write_train_goldens(names=()) -> None:
    """Both train goldens of gemma3-1b, or of ``names``; prints each
    one's seconds and the process's peak RSS so far."""
    for name in names or (LM_NAME,):
        for cfg in (get_config(name), get_config(name).reduced()):
            t0 = time.perf_counter()
            np.savez(train_golden_path(cfg), **train_golden(cfg))
            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            print(f"wrote {train_golden_path(cfg)} in "
                  f"{time.perf_counter() - t0:.1f} s (peak RSS so far "
                  f"{rss / 2**20:.2f} GiB)", flush=True)


def _same_train_golden(have, want) -> None:
    assert sorted(have) == sorted(want)
    for k in want:
        if k in TRAIN_GOLDEN_FLOATS:
            np.testing.assert_allclose(have[k], want[k], rtol=1e-4,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(have[k], want[k], err_msg=k)


def test_the_reduced_train_golden_matches_a_fresh_reference_run():
    cfg = get_config(LM_NAME).reduced()
    with np.load(train_golden_path(cfg)) as g:
        _same_train_golden({k: g[k] for k in g.files}, train_golden(cfg))


def test_the_full_width_train_golden_is_the_recipe_of_record():
    """The committed full-width train golden was written from
    ``lm_params`` of the current recipe at the recipe's batch, steps and
    optimizer, its batches are ``synthetic_batch``'s, and it is small."""
    cfg = port_get_config(LM_NAME)
    path = train_golden_path(cfg)
    assert path.stat().st_size < 1 << 20
    with np.load(path) as g:
        assert str(g["config"]) == LM_NAME
        assert int(g["seed"]) == PARAMS_SEED
        assert int(g["recipe_version"]) == LM_PARAMS_VERSION
        assert (int(g["batch"]), int(g["seq"])) == (TRAIN_GOLDEN_BATCH,
                                                    TRAIN_GOLDEN_SEQ)
        opt = ref_opt.AdamWConfig(**TRAIN_GOLDEN_OPT)
        for f in dataclasses.fields(opt):
            assert g["opt_" + f.name].item() == getattr(opt, f.name)
        for k in ("loss", "grad_norm", "lr", "update_norm"):
            assert g[k].shape == (TRAIN_GOLDEN_STEPS,)
            assert np.isfinite(g[k]).all() and (g[k] > 0).all()
        assert g["update_dot"].shape == (TRAIN_GOLDEN_STEPS,)
        assert (g["update_dot"] < 0).all()   # each step descends
        keys = ["|".join(p) for p, _ in leaves_with_paths(build_model(
            cfg).init(torch.Generator(), device="meta"))]
        assert list(g["leaf_keys"]) == keys
        for k in ("leaf_norms", "leaf_update_dots", "leaf_mu_norms"):
            assert g[k].shape == (len(keys),)
            assert np.isfinite(g[k]).all()
        for i in range(TRAIN_GOLDEN_STEPS):
            b = port_synthetic_batch(cfg, TRAIN_GOLDEN_BATCH,
                                     TRAIN_GOLDEN_SEQ, i)
            assert np.array_equal(b["tokens"].numpy(), g["tokens"][i])
            assert np.array_equal(b["labels"].numpy(), g["labels"][i])


def test_the_port_holds_the_reduced_train_golden():
    """The port on the CPU, trained as the golden's recipe says: the
    batches bitwise, each step's loss, grad_norm and lr and step 0's
    per-leaf gradient norms within rtol 2e-2 (the check ``chip_smoke.py``
    makes at full width on the card)."""
    cfg = port_get_config(LM_NAME).reduced()
    with np.load(train_golden_path(cfg)) as g:
        held = hold_train_golden(cfg, lm_params(cfg, PARAMS_SEED),
                                 {k: g[k] for k in g.files}, "cpu")
    assert held["ok"], held["errs"]


if __name__ == "__main__":
    if "--sliced" in sys.argv[1:]:
        write_sliced_asset()
        print(f"wrote the sliced {SLICED_NET} artifact and golden in "
              f"{ASSETS}")
    elif "--zoo" in sys.argv[1:]:
        write_zoo_assets(tuple(sys.argv[sys.argv.index("--zoo") + 1:])
                         or ZOO_NETS)
    elif "--lm" in sys.argv[1:]:
        write_lm_goldens(tuple(sys.argv[sys.argv.index("--lm") + 1:]))
    elif "--train" in sys.argv[1:]:
        write_train_goldens(tuple(sys.argv[sys.argv.index("--train") + 1:]))
    else:
        write_assets()
        print(f"wrote the artifacts and goldens of {NETS + STREAMS} and of "
              f"the fp32 {FLOAT_NETS + FLOAT_STREAMS + SEEDED_FLOAT_NETS} "
              f"in {ASSETS}")
