"""The port's collectives (``repro_torch.parallel.collectives``) against the
reference's ``repro.parallel.collectives``, on the CPU, in one process.

The reference's collectives run here jitted, as they run in its train
step, under ``jax.vmap(f, axis_name="dp")`` over a stack of the
participants' inputs (its own test file runs them under
``jax.experimental.shard_map``, which warns that it is deprecated).
Compiled, XLA computes the scale's ``/ 127`` as a product with fp32
``1/127`` (op by op it divides, one ulp apart for some maxima); the
port computes the compiled form.  The port's one-process forms (``*_stacked``, a list of
per-rank inputs) run the arithmetic its process-group forms run, with
the reduction over the participants in place of ``all_reduce``.  No
test here opens a process group.

* the int8 codec is the reference's bit for bit, on seeded arrays and on
  an all-zero one;
* ``compressed_psum`` and ``bucketed_psum`` at 1, 2 and 4 participants:
  every participant's result the reference's, bitwise when compressed,
  else within rtol 1e-6, atol 1e-6 x max (fp32 sums in another order);
* ``bucketed_psum`` keeps the tree's structure and each leaf's dtype,
  and the int8 payload is 4 x smaller than fp32.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel.collectives import bucketed_psum as ref_bucketed_psum
from repro.parallel.collectives import \
    compressed_psum as ref_compressed_psum
from repro.parallel.collectives import dequantize_int8 as ref_dequantize
from repro.parallel.collectives import quantize_int8 as ref_quantize
from repro_torch.parallel import (bucketed_psum_stacked,
                                  compressed_psum_stacked, dequantize_int8,
                                  quantize_int8)

RTOL = ATOL_REL = 1e-6
PARTICIPANTS = (1, 2, 4)


def _draws(n: int, shape, seed: int = 0) -> list[np.ndarray]:
    """``n`` participants' seeded fp32 inputs, of different scales."""
    return [(np.random.default_rng([seed, r]).standard_normal(shape)
             * (1 + 3 * r)).astype(np.float32) for r in range(n)]


def _trees(n: int, seed: int = 0) -> list[dict]:
    """``n`` participants' trees: an fp32 matrix, a ragged vector and a
    bf16 leaf (its values held as fp32 numpy)."""
    out = []
    for r in range(n):
        rng = np.random.default_rng([seed, 10 + r])
        out.append({"w": (rng.standard_normal((13, 17)) * (r + 1))
                    .astype(np.float32),
                    "b": rng.standard_normal(7).astype(np.float32),
                    "h": rng.standard_normal((3, 5)).astype(np.float32)})
    return out


def _port_tree(t: dict) -> dict:
    return {"w": torch.from_numpy(t["w"]), "b": torch.from_numpy(t["b"]),
            "h": torch.from_numpy(t["h"]).to(torch.bfloat16)}


def _ref_tree(trees: list[dict]) -> dict:
    """The participants' trees stacked, the bf16 leaf as jax bf16."""
    return {"w": jnp.stack([t["w"] for t in trees]),
            "b": jnp.stack([t["b"] for t in trees]),
            "h": jnp.stack([t["h"] for t in trees]).astype(jnp.bfloat16)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("case", ["normal", "wide", "zeros", "one"])
def test_the_codec_is_the_references_bit_for_bit(case):
    x = {"normal": _draws(1, (257,))[0],
         "wide": _draws(1, (64, 33), seed=3)[0] * 1e4,
         "zeros": np.zeros((5, 6), np.float32),
         "one": np.array([-2.5], np.float32)}[case]
    q, s = quantize_int8(torch.from_numpy(x))
    rq, rs = jax.jit(ref_quantize)(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert s.numpy().tobytes() == np.asarray(rs).tobytes()
    back = dequantize_int8(q, s)
    assert back.numpy().tobytes() == np.asarray(ref_dequantize(rq, rs)) \
        .tobytes()
    assert float(np.abs(back.numpy() - x).max()) <= float(s) * 0.5 + 1e-6


@pytest.mark.parametrize("n", PARTICIPANTS)
@pytest.mark.parametrize("shape", [(64,), (9, 31)])
def test_compressed_psum_is_the_references_bit_for_bit(n, shape):
    xs = _draws(n, shape, seed=n)
    got = compressed_psum_stacked([torch.from_numpy(x) for x in xs])
    want = jax.jit(jax.vmap(functools.partial(ref_compressed_psum,
                                              axis_name="dp"),
                            axis_name="dp"))(jnp.stack(xs))
    for r in range(n):
        assert got[r].numpy().tobytes() == np.asarray(want[r]).tobytes(), r
    # one participant: the only error is the quantization's
    if n == 1:
        scale = float(np.abs(xs[0]).max()) / 127.0
        np.testing.assert_allclose(got[0].numpy(), xs[0],
                                   atol=scale * 0.51 + 1e-7)


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("bucket_bytes", [64, 256, 4 << 20])
@pytest.mark.parametrize("n", PARTICIPANTS)
def test_bucketed_psum_is_the_references(n, bucket_bytes, compressed):
    trees = _trees(n, seed=bucket_bytes)
    got = bucketed_psum_stacked([_port_tree(t) for t in trees],
                                bucket_bytes=bucket_bytes,
                                compressed=compressed)
    want = jax.jit(jax.vmap(functools.partial(
        ref_bucketed_psum, axis_name="dp", bucket_bytes=bucket_bytes,
        compressed=compressed), axis_name="dp"))(_ref_tree(trees))
    for r in range(n):
        assert sorted(got[r]) == sorted(want)
        for k in want:
            g, w = _np(got[r][k]), _np(want[k][r])
            assert g.shape == w.shape
            if compressed or k == "h":   # bf16: the rounding of the same sum
                assert g.tobytes() == w.tobytes(), (r, k)
            else:
                np.testing.assert_allclose(
                    g, w, rtol=RTOL, atol=ATOL_REL * np.abs(w).max())


def test_bucketed_psum_keeps_the_tree_and_its_dtypes():
    tree = {"w": torch.ones(130), "b": torch.arange(7, dtype=torch.float32),
            "h": torch.full((2, 3), 1.5, dtype=torch.bfloat16),
            "n": (torch.ones(3), [torch.zeros(2)])}
    out = bucketed_psum_stacked([tree], bucket_bytes=256)[0]
    assert out["n"][1][0].shape == (2,) and isinstance(out["n"], tuple)
    assert isinstance(out["n"][1], list)
    for k in ("w", "b", "h"):
        assert out[k].dtype == tree[k].dtype
        assert torch.equal(out[k], tree[k])
    two = bucketed_psum_stacked([tree, tree], bucket_bytes=256)
    assert torch.equal(two[1]["w"], 2 * tree["w"])


def test_the_int8_payload_is_four_times_smaller_than_fp32():
    x = torch.ones(1024)
    q, _ = quantize_int8(x)
    assert q.dtype == torch.int8
    assert q.nbytes * 4 == x.nbytes
