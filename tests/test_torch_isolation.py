"""``repro_torch``, ``chip_smoke.py`` and ``tools/chip_ab.py`` stand alone:
they import neither JAX nor anything of the reference package ``repro``,
by the source and in a run with both blocked — in which the port also
compiles DS-CNN for the M4 with its default passes, runs the result,
compiles the committed plan from the reference's params and calibration
inputs, proves VWW's plan statically, emits its C, runs both of its
compile and lint command lines' ``--smoke`` gates, compiles ImageNet
for the M4 with ``partial="auto"``, serves the sliced plan, traces a run
and runs the trace command line's ``--smoke`` in a temporary
directory; serves a reduced model of each LM block and FFN kind (rec,
ssm, MoE, lead layers, cross-attention over encoder frames and image
tokens, an untied unembedding), runs the serving command, trains the
reduced gemma3-1b for 2 steps, checkpoints and restores it, runs the
training command, runs the FC chain through the ring and
``ops.segment_gemm`` against its oracle, and imports the mesh path
(``parallel``, ``launch.mesh``, ``launch.specs``) and runs its rules and
one-process collectives, and reduced granite-moe's forward over a
``(data, model) = (2, 2)`` stand-in mesh."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py", ROOT / "tools" / "chip_ab.py",
       ROOT / "tools" / "mesh_check.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_sources_exist():
    names = {p.name for p in SOURCES}
    assert {"chip_smoke.py", "quantized.py", "stream.py", "session.py",
            "executors.py", "driver.py", "segment_matmul.py", "conv2d.py",
            "_launch.py", "cases.py", "run.py", "program.py",
            "inverted_bottleneck.py", "requant.py", "fused_mlp.py",
            "elementwise.py", "ring_decode.py", "ops.py", "base.py",
            "gemma3_1b.py", "common.py", "transformer.py", "registry.py",
            "engine.py", "spans.py", "affine.py", "planner.py",
            "graph_planner.py", "baselines.py", "rowsched.py", "pool.py",
            "ir.py", "schedule.py", "netplan.py", "convert.py",
            "qtensor.py", "lint.py", "verifier.py", "targets.py",
            "artifact.py", "intervals.py", "mutate.py", "codegen.py",
            "cli.py", "slicer.py", "lower.py", "counters.py",
            "timeline.py", "tracer.py", "analysis.py", "rglru.py",
            "mamba2.py", "moe.py", "ring_buffer.py", "ref.py",
            "serve.py", "train.py", "data.py", "optimizer.py",
            "train_step.py", "tree.py", "manager.py", "sharding.py",
            "collectives.py", "mesh.py", "specs.py",
            "mesh_check.py"} <= names
    src = ROOT / "src" / "repro_torch"
    assert (src / "cli.py").exists()
    assert (src / "analysis" / "cli.py").exists()
    for module in ("partial/__init__.py", "obs/cli.py",
                   "roofline/__init__.py", "launch/__init__.py",
                   "launch/serve.py", "models/rglru.py", "models/mamba2.py",
                   "models/moe.py", "core/ring_buffer.py",
                   "kernels/ref.py"):
        assert (src / module).exists()
    assert (ROOT / "src" / "repro_torch" / "kernels" / "csrc"
            / "ring_decode.cu").exists()
    assert all(p.exists() for p in SOURCES)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(line, name) for line, name in _imports(path)
           if _forbidden(name)]
    assert not bad, f"{path}: {bad}"


def test_cpu_run_with_jax_and_repro_blocked():
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np, torch
torch.set_num_threads(1)
import repro_torch
assets = {str(ROOT / "src" / "repro_torch" / "assets")!r}
cn = repro_torch.load(assets + "/ds-cnn.cortex-m4.int8.json")
with np.load(assets + "/ds-cnn.cortex-m4.int8.golden.npz") as g:
    x, want = g["x"][:2], g["y"][:2]
y = cn.run(x, device="cpu")
assert np.array_equal(y.numpy(), want)
cn = repro_torch.load(assets + "/resnet-8.cortex-m4.int8.json")
with np.load(assets + "/resnet-8.cortex-m4.int8.golden.npz") as g:
    assert np.array_equal(cn.run(g["x"][0], device="cpu").numpy(), g["y"][0])
cn = repro_torch.load(assets + "/resnet-8.host-sim.float32.json")
with np.load(assets + "/resnet-8.host-sim.float32.golden.npz") as g:
    y, want = cn.run(g["x"][0], device="cpu").numpy(), g["y"][0]
    assert np.allclose(y, want, rtol=3e-4, atol=3e-5 * np.abs(want).max())
cn = repro_torch.load(assets + "/mcunet-5fps-vww.host-sim.float32.json")
with np.load(assets + "/mcunet-5fps-vww.host-sim.float32.golden.npz") as g:
    y, want = cn.run(g["x"][0], device="cpu").numpy(), g["y"][0]
    assert np.allclose(y, want, rtol=3e-4, atol=3e-5 * np.abs(want).max())
s = repro_torch.load(assets + "/kws-gru-chain.host-sim.float32.json").stream(
    device="cpu")
with np.load(assets + "/kws-gru-chain.host-sim.float32.golden.npz") as g:
    for f, want in zip(g["x"][:3], g["y"]):
        y = s.step(torch.from_numpy(f)).numpy()
        assert np.allclose(y, want, rtol=3e-4, atol=3e-5 * np.abs(want).max())
s = repro_torch.load(assets + "/kws-gru-chain.cortex-m4.int8.json").stream(
    device="cpu")
with np.load(assets + "/kws-gru-chain.cortex-m4.int8.golden.npz") as g:
    for f, want in zip(g["x_q"][:3], g["y_q"]):
        assert np.array_equal(s.step(torch.from_numpy(f)).numpy(), want)
from repro_torch.kernels.cases import seeded_float_net
cn = seeded_float_net(assets + "/whisper-tiny-mlp.host-sim.float32.json", 0)
x = np.random.default_rng(0).standard_normal((2, 1500, 384), np.float32)
with np.load(assets + "/whisper-tiny-mlp.host-sim.float32.golden.npz") as g:
    y, want = cn.run(x[1], device="cpu").numpy()[g["rows"]], g["y"][1]
    assert np.allclose(y, want, rtol=3e-4, atol=3e-5 * np.abs(want).max())
from repro_torch.configs import get_config
from repro_torch.kernels.cases import hold_lm_golden, lm_params
from repro_torch.models import build_model, params_from_reference
from repro_torch.serve import ServingEngine
cfg = get_config("gemma3-1b").reduced()
params = params_from_reference(cfg, lm_params(cfg, 0), "cpu")
out = ServingEngine(build_model(cfg), params, cache_len=48).generate(
    [[5, 6, 7], list(range(1, 41))], max_new=4)
assert [len(o) for o in out] == [4, 4]
with np.load(assets + "/gemma3-1b-smoke.golden.npz") as g:
    assert hold_lm_golden(build_model(cfg), params, dict(g))["ok"]
from repro_torch.kernels.cases import lm_memory
for name in ("recurrentgemma-2b", "mamba2-780m", "granite-moe-1b-a400m",
             "deepseek-moe-16b", "whisper-tiny", "llama-3.2-vision-90b"):
    cfg = get_config(name).reduced()
    params = params_from_reference(cfg, lm_params(cfg, 0), "cpu")
    mem = lm_memory(cfg, 0, 2)
    out = ServingEngine(build_model(cfg), params, cache_len=48).generate(
        [[5, 6, 7], list(range(1, 41))], max_new=3,
        memory=None if mem is None else torch.from_numpy(mem))
    assert [len(o) for o in out] == [3, 3], name
import contextlib, io
from repro_torch.launch.serve import main as serve_main
with contextlib.redirect_stdout(io.StringIO()) as buf:
    serve_main(["--arch", "whisper-tiny", "--reduced", "--device", "cpu",
                "--max-new", "2"])
assert buf.getvalue().startswith("generated 8 tokens")
import tempfile
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch.train import main as train_main
from repro_torch.train import init_state, make_train_step, synthetic_batch
from repro_torch.train.train_step import eval_state_shapes
from repro_torch.train.tree import leaves, unflatten_like
cfg = get_config("gemma3-1b").reduced()
model = build_model(cfg)
tree = lm_params(cfg, 0)
state = init_state(unflatten_like(tree, [torch.tensor(a)
                                         for a in leaves(tree)]))
step = make_train_step(model)
for i in range(2):
    state, metrics = step(state, synthetic_batch(cfg, 2, 8, i))
    assert torch.isfinite(metrics["loss"])
with tempfile.TemporaryDirectory() as tmp:
    mgr = CheckpointManager(tmp)
    mgr.save_async(2, state)
    mgr.wait()
    back = mgr.restore(eval_state_shapes(model))
    assert int(back.step) == 2
    assert all(torch.equal(a, b) for a, b in zip(leaves(back),
                                                 leaves(state)))
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        train_main(["--arch", "gemma3-1b", "--reduced", "--device", "cpu",
                    "--steps", "2", "--batch", "2", "--seq", "8",
                    "--ckpt-dir", tmp + "/run"])
    assert "'final_loss'" in buf.getvalue()
    assert CheckpointManager(tmp + "/run").latest_step() == 2
from repro_torch.configs.base import TRAIN_4K
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.launch.specs import make_rules
from repro_torch.parallel import (compressed_psum_stacked,
                                  dequantize_int8, quantize_int8)
rules = make_rules(get_config("gemma3-1b"), None, TRAIN_4K)
assert rules.param_spec("embed", 2) == ("model", "data")
assert production_mesh_shape(multi_pod=True)[1] == ("pod", "data", "model")
x = torch.linspace(-3, 2, 11)
assert torch.equal(compressed_psum_stacked([x])[0],
                   dequantize_int8(*quantize_int8(x)))
from repro_torch.parallel import StandInMesh
from repro_torch.models.transformer import vocab_logits
cfg = get_config("granite-moe-1b-a400m").reduced()
mesh = StandInMesh((2, 2))
rules = make_rules(cfg, mesh, TRAIN_4K)
params = params_from_reference(cfg, lm_params(cfg, 0), "cpu")
toks = torch.arange(1, 25).reshape(2, 12)
got = mesh.run(lambda c: vocab_logits(build_model(cfg).forward(
    rules.rank_tree(params), rules.sharding("batch", None).local(toks),
    rules=rules)[0], rules))
assert got[(0, 0)].shape == (1, 12, cfg.vocab)
assert torch.equal(got[(1, 0)], got[(1, 1)])
from repro_torch.core.ring_buffer import (init_chain_params,
                                          naive_chain_apply, plan_chain,
                                          run_chain_via_ring)
from repro_torch.kernels import ops, ref
plan = plan_chain(8, [96, 384, 96], seg_width=32)
chain = init_chain_params(torch.Generator().manual_seed(0), [96, 384, 96])
x = torch.randn((8, 96), generator=torch.Generator().manual_seed(1))
assert torch.allclose(run_chain_via_ring(x, chain, plan),
                      naive_chain_apply(x, chain), atol=1e-4)
w = torch.randn((96, 40), generator=torch.Generator().manual_seed(2))
y, info = ops.segment_gemm(x, w)
assert torch.allclose(y, ref.gemm_ref(x, w, torch.zeros(40)), atol=1e-4)
cn = repro_torch.compile("ds-cnn", "cortex-m4")
assert [p.name for p in cn.passes] == ["build", "schedule", "plan",
                                       "budget", "quantize", "lint",
                                       "certify"]
assert cn.certificate["clobbers"] == 0 and cn.quantized
y = cn.run(np.random.default_rng(0).standard_normal((49, 10), np.float32),
           device="cpu")
assert y.shape == (1, 12) and torch.isfinite(y).all()
from repro_torch.compile.artifact import read_compile_inputs
params, calib = read_compile_inputs(
    assets + "/ds-cnn.cortex-m4.int8.compile.npz")
cn = repro_torch.compile("ds-cnn", "cortex-m4", params=params, calib=calib)
want = repro_torch.load(assets + "/ds-cnn.cortex-m4.int8.json")
assert cn.program == want.program and cn.certificate == want.certificate
assert cn.mcu == want.mcu
cn = repro_torch.compile("mcunet-5fps-vww", "cortex-m4", quantize=False,
                         certify="static")
assert cn.passes[-1].note.startswith("static proof")
units = cn.emit_c(geometry_only=True, name="vww")
golden = {str(ROOT / "tests" / "golden" / "vww")!r}
import pathlib
assert units == {{p.name: p.read_text()
                 for p in pathlib.Path(golden).glob("*.c")}}
from repro_torch.analysis.cli import main as lint_main
from repro_torch.cli import main as compile_main
assert compile_main(["--smoke"]) == 0
assert lint_main(["--smoke"]) == 0
cn = repro_torch.compile("mcunet-320kb-imagenet", "cortex-m4", quantize=False,
                         certify="static", partial="auto")
assert cn.partial["total_slices"] == 36 and len(cn.program.ops) == 158
sliced = assets + "/mcunet-320kb-imagenet.cortex-m4.int8.sliced"
cn = repro_torch.load(sliced + ".json")
with np.load(sliced + ".golden.npz") as g:
    y, art = cn.run(g["x"][0], device="cpu", trace=True)
    assert np.array_equal(y.numpy(), g["y"][0])
from repro_torch.roofline import ring_traffic_summary
assert ring_traffic_summary(art)["macs"] > 0
import os, tempfile
from repro_torch.obs.cli import main as trace_main
with tempfile.TemporaryDirectory() as tmp:
    os.chdir(tmp)
    assert trace_main(["--smoke"]) == 0
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m, mod in sys.modules.items() if mod is not None)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
