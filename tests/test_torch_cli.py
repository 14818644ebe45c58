"""The port's two command lines held against the reference's on the CPU:
``python -m repro_torch.cli`` (``vmcu-compile``) and
``python -m repro_torch.analysis.cli`` (``vmcu-lint``).

Each ``main(argv)`` is called on the same arguments as the reference's:
the same exit code and the same standard output, once the seconds of
the pass lines are taken out, ``--partial`` included (its sliced
ImageNet lines are in ``tests/test_torch_partial.py``).
"""
import contextlib
import io
import json
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from repro.analysis.cli import main as ref_lint_main
from repro.cli import main as ref_compile_main
from repro_torch.analysis.cli import main as lint_main
from repro_torch.cli import main as compile_main
from repro_torch.compile import artifact

ROOT = pathlib.Path(__file__).resolve().parents[1]
ASSETS = pathlib.Path(artifact.__file__).parents[1] / "assets"
GOLDEN_VWW = ROOT / "tests" / "golden" / "vww"
_SECONDS = re.compile(r"(?m)^(    pass \S+)\s+\d+\.\d+s ")


def _call(main, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:          # argparse's own usage errors
            rc = e.code
    return rc, _SECONDS.sub(r"\1 ", out.getvalue()), err.getvalue()


def _same(port_main, ref_main, argv) -> tuple[int, str, str]:
    have, want = _call(port_main, argv), _call(ref_main, argv)
    assert have[:2] == want[:2], (argv, have[2], want[2])
    return have


@pytest.fixture(scope="module")
def smoke():
    """Both compile lines' ``--smoke`` run once (the reference's
    calibrates MCUNet-VWW in int8, which takes it about 20 s here; a
    second call reuses its compiled functions)."""
    return _same(compile_main, ref_compile_main,
                 ["--smoke", "--golden-dir", str(GOLDEN_VWW)])


# ---------------------------------------------------------------------------
# python -m repro_torch.cli
# ---------------------------------------------------------------------------

def test_the_compile_smoke_is_the_references(smoke):
    rc, out, _ = smoke
    assert rc == 0
    assert "smoke OK: SRAM gate passed, 38 C units match" in out
    assert "pass certify" in out and "fits_sram                    True" \
        in out


@pytest.mark.parametrize("argv,code", [
    (["--list-targets"], 0), (["--list-nets"], 0),
    (["--smoke", "resnet-8"], 2), (["ds-cnn", "--partial", "half"], 2),
    (["--from-artifact"], 2),
    (["mcunet-320kb-imagenet", "--target", "cortex-m4"], 2),
    (["ds-cnn", "--target", "cortex-m4", "--no-quantize", "--certify",
      "static"], 0),
    (["resnet-8", "--target", "cortex-m7", "--no-quantize", "--no-certify",
      "--no-budget"], 0),
    (["ds-cnn", "--dtype", "bfloat16"], 0),
    (["kws", "--certify", "never"], 2)], ids=lambda a: " ".join(map(str, a))
    if isinstance(a, list) else str(a))
def test_compile_lines_are_the_references(smoke, argv, code):
    assert _same(compile_main, ref_compile_main, argv)[0] == code


def test_a_drifted_golden_fails_the_smoke_as_in_the_reference(smoke,
                                                              tmp_path):
    golden = tmp_path / "vww"
    shutil.copytree(GOLDEN_VWW, golden)
    unit = golden / "vww_op05_conv_dw.c"
    text = unit.read_text()
    unit.write_text(text.replace("POOL_SEGS 900", "POOL_SEGS 901", 1))
    argv = ["--smoke", "--golden-dir", str(golden)]
    rc, _, err = _same(compile_main, ref_compile_main, argv)
    assert rc == 1 and "DRIFT vs golden" in err
    (golden / "vww_op99_extra.c").write_text("// stale\n")
    unit.unlink()
    rc, _, err = _same(compile_main, ref_compile_main, argv)
    assert rc == 1 and "MISSING golden" in err and "STALE golden" in err
    rc, _, _ = _same(compile_main, ref_compile_main,
                     ["--smoke", "--golden-dir", str(tmp_path / "none")])
    assert rc == 2


def test_emit_c_writes_the_reference_units(smoke, tmp_path):
    cdir = tmp_path / "c"
    files = []
    for main in (ref_compile_main, compile_main):
        argv = ["mcunet-5fps-vww", "--emit-c", str(cdir)]
        files.append(_call(main, argv)[:2])
        files[-1] += ({p.name: p.read_text() for p in cdir.iterdir()},)
        shutil.rmtree(cdir)
    assert files[0] == files[1]
    rc, out, units = files[1]
    assert rc == 0 and f"wrote 21 C units to {cdir}" in out
    assert len(units) == 21


def test_save_then_from_artifact_is_the_references(smoke, tmp_path):
    """Each line saves its compile and loads it back: the same report
    both times (the port saves its own fp32 draws, of the same shapes)."""
    path = str(tmp_path / "ds-cnn.json")
    outs = []
    for main in (ref_compile_main, compile_main):
        outs.append(_call(main, ["ds-cnn", "--target", "cortex-m4",
                                 "--no-quantize", "--certify", "static",
                                 "--save", path]))
        outs.append(_call(main, [path, "--from-artifact"]))
    assert outs[0][:2] == outs[2][:2] and outs[1][:2] == outs[3][:2]
    assert outs[0][0] == outs[1][0] == 0
    assert f"loaded {path} (ds-cnn for cortex-m4)" in outs[3][1]


def test_partial_is_refused_by_name():
    """``--partial`` is no longer refused: ``auto`` (not needed on
    DS-CNN) and a forced slice count compile as the reference's do, to
    the same report."""
    for value in ("auto", "3"):
        argv = ["ds-cnn", "--target", "cortex-m4", "--no-quantize",
                "--partial", value]
        rc, out, err = _same(compile_main, ref_compile_main, argv)
        assert rc == 0 and "Traceback" not in err
        assert "pass partial" in out


def test_the_port_compile_line_runs_as_a_module():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-m", "repro_torch.cli",
                          "--list-targets"], env=env, capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    want = _call(ref_compile_main, ["--list-targets"])[1]
    assert out.stdout == want


# ---------------------------------------------------------------------------
# python -m repro_torch.analysis.cli
# ---------------------------------------------------------------------------

def test_the_lint_smoke_is_the_references():
    rc, out, _ = _same(lint_main, ref_lint_main, ["--smoke"])
    assert rc == 0 and out.endswith("vmcu-lint smoke OK\n")
    assert "tampered artifact rejected: VMCU102, VMCU403" in out


def _tampered(tmp_path) -> pathlib.Path:
    payload = json.loads((ASSETS / "ds-cnn.cortex-m4.int8.json").read_text())
    payload["program"]["ops"][1]["out_ptr"] += 1
    bad = tmp_path / "tampered.json"
    bad.write_text(json.dumps(payload))
    return bad


def test_lint_lines_are_the_references(tmp_path):
    clean = [str(ASSETS / "ds-cnn.cortex-m4.int8.json"),
             str(ASSETS / "mcunet-5fps-vww.host-sim.float32.json")]
    unreadable = tmp_path / "junk.json"
    unreadable.write_text("not json")
    cases = [(clean, 0), ([str(_tampered(tmp_path))], 1),
             ([str(unreadable)], 1), ([str(tmp_path / "absent.json")], 1),
             ([clean[0], str(_tampered(tmp_path))], 1), ([], 2),
             (["--smoke", clean[0]], 2)]
    for argv, code in cases:
        rc, _, _ = _same(lint_main, ref_lint_main, argv)
        assert rc == code, argv


def test_lint_of_emitted_c_is_the_references(tmp_path):
    plan = ASSETS / "resnet-8.cortex-m4.int8.json"
    cdir = tmp_path / "c"
    assert compile_main([str(plan), "--from-artifact", "--emit-c",
                         str(cdir)]) == 0
    argv = [str(plan), "--c-dir", str(cdir)]
    assert _same(lint_main, ref_lint_main, argv)[0] == 0
    units = sorted(cdir.glob("*.c"))
    units[2].write_text(units[2].read_text().replace("WRAP(", "WRAP(1 + ",
                                                     1))
    units[3].unlink()
    rc, out, _ = _same(lint_main, ref_lint_main, argv)
    assert rc == 1 and "VMCU501" in out and "VMCU502" in out
