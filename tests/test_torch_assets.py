"""The port's committed plan artifact and golden outputs, held against a
fresh compile and a fresh run of the reference.

``repro_torch`` serves DS-CNN from a plan artifact that the reference
compiler writes; the machine with the GPU has no JAX, so the artifact
and the reference's outputs on it are committed with the port.  A stale
asset fails here, not on the card.  Run this file as a script to
rewrite both:

    PYTHONPATH=src python tests/test_torch_assets.py
"""
import hashlib
import json
import pathlib

import numpy as np

import repro
from repro.core.executors import run_program
from repro.quant import QParams, quantize

ASSETS = (pathlib.Path(__file__).resolve().parents[1] / "src"
          / "repro_torch" / "assets")
ARTIFACT = ASSETS / "ds-cnn.cortex-m4.int8.json"
GOLDEN = ASSETS / "ds-cnn.cortex-m4.int8.golden.npz"
NET, TARGET = "ds-cnn", "cortex-m4"


def golden_inputs() -> np.ndarray:
    return np.random.default_rng(0).standard_normal((8, 490, 1),
                                                    np.float32)


def reference_golden(path) -> dict:
    """The reference's float outputs (``run(x, backend="jnp")`` on the
    batch), int8 outputs and final-pool sha256 per input."""
    cn = repro.load(str(path))
    x = golden_inputs()
    y = np.asarray(cn.run(x, backend="jnp"))
    qn = cn.qnet
    y_q, shas = [], []
    for xi in x:
        yq, pool = run_program(qn.program,
                               quantize(xi, QParams(scale=qn.in_scale)),
                               qn.qparams, backend="jnp")
        y_q.append(np.asarray(yq))
        shas.append(hashlib.sha256(np.asarray(pool.array).tobytes())
                    .hexdigest())
    return {"x": x, "y": y, "y_q": np.stack(y_q),
            "pool_sha256": np.array(shas)}


def write_assets() -> None:
    ASSETS.mkdir(parents=True, exist_ok=True)
    repro.compile(NET, TARGET).save(str(ARTIFACT))
    np.savez(GOLDEN, **reference_golden(ARTIFACT))


def test_artifact_matches_a_fresh_compile(tmp_path):
    fresh = tmp_path / "fresh.json"
    repro.compile(NET, TARGET).save(str(fresh))
    have = json.loads(ARTIFACT.read_text())
    want = json.loads(fresh.read_text())
    for key in ("program", "params", "quant", "certificate"):
        assert have[key] == want[key], key


def test_golden_matches_a_fresh_reference_run():
    want = reference_golden(ARTIFACT)
    with np.load(GOLDEN) as have:
        assert sorted(have.files) == sorted(want)
        for key, arr in want.items():
            np.testing.assert_array_equal(have[key], arr, err_msg=key)
    # the float golden is the dequantized int8 golden
    assert want["y"].shape == want["y_q"].shape == (8, 1, 12)


if __name__ == "__main__":
    write_assets()
    print(f"wrote {ARTIFACT} and {GOLDEN}")
