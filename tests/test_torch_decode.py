"""The port's decode attention over a ring KV cache
(``repro_torch.kernels.ring_decode``, ``repro_torch.kernels.ops``) against
the reference's, on the CPU.

* The plain version (the Pallas body's block-by-block online softmax in
  PyTorch) against the reference's Pallas kernel in interpret mode and
  against its oracle ``ring_decode_ref``, on every case of
  ``repro_torch.kernels.cases.DECODE_CASES``: the reference's kernel-test
  grid and softcap case in fp32 within rtol and atol 2e-5
  (``tests/test_kernels.py:80``), gemma3-1b's bf16 shapes within one bf16
  ulp of the output's scale.  A batched case is held row by row; a
  window that ``block`` does not divide (a global cache of 1,000 slots)
  is held against the oracle only, since the Pallas kernel refuses it.
* ``ops.decode_attention`` on the CPU against the reference's
  ``ops.decode_attention``, the ``block must divide window`` error,
  ``ring_cache_update``'s modular slot and the port's oracle.
* The CUDA wrapper's argument checks; it refuses CPU tensors rather than
  fall back.  The kernel itself runs only on the card
  (``tests/test_torch_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.ref import ring_decode_ref as ref_oracle
from repro.kernels.ring_decode import ring_cache_update as ref_cache_update
from repro.kernels.ring_decode import ring_decode_attention as ref_kernel
from repro_torch.kernels import KERNELS, PLAIN, ops
from repro_torch.kernels.cases import (DECODE_CASES, DecodeCase, bf16_ulp,
                                       compare_decode, decode_inputs)
from repro_torch.kernels.ring_decode import (decode_smem,
                                             ring_cache_update,
                                             ring_decode_attention,
                                             ring_decode_attention_plain,
                                             ring_decode_ref)

torch.set_num_threads(2)


def _torch(case, arrays):
    dt = getattr(torch, case.dtype)
    return [torch.from_numpy(a).to(dt) for a in arrays]


def _rows(case, q, k, v, seq):
    """The case's calls in the reference's unbatched layout."""
    if not case.batch:
        return [(q, k, v, seq)]
    seqs = np.broadcast_to(np.asarray(seq), (case.batch,))
    return [(q[b], k[b], v[b], int(seqs[b])) for b in range(case.batch)]


def _reference(fn, case, q, k, v, seq, **kw):
    """The reference's ``fn`` on every row of the case, stacked, fp32."""
    dt = jnp.dtype(case.dtype)
    outs = [np.asarray(fn(jnp.asarray(qr).astype(dt),
                          jnp.asarray(kr).astype(dt),
                          jnp.asarray(vr).astype(dt),
                          jnp.asarray(s, jnp.int32), **kw)
                       .astype(jnp.float32))
            for qr, kr, vr, s in _rows(case, q, k, v, seq)]
    return np.stack(outs) if case.batch else outs[0]


def _check(case, got, want):
    err, bad = compare_decode(got.to(torch.float32).numpy(), want,
                              case.dtype)
    assert bad is None, f"{case.name}: {bad} (max |difference| {err:.3g})"


@pytest.mark.parametrize("case", [c for c in DECODE_CASES
                                  if c.window % c.block == 0],
                         ids=lambda c: c.name)
def test_plain_matches_reference_pallas_kernel(case):
    q, k, v, seq = decode_inputs(case)
    got = ring_decode_attention_plain(*_torch(case, (q, k, v)),
                                      torch.as_tensor(seq), **case.kwargs)
    assert got.dtype == getattr(torch, case.dtype)
    want = _reference(ref_kernel, case, q, k, v, seq, interpret=True,
                      **case.kwargs)
    _check(case, got, want)


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: c.name)
def test_plain_and_port_oracle_match_reference_oracle(case):
    q, k, v, seq = decode_inputs(case)
    want = _reference(ref_oracle, case, q, k, v, seq, window=case.window,
                      softcap=case.softcap)
    tq, tk, tv = _torch(case, (q, k, v))
    _check(case, ring_decode_attention_plain(tq, tk, tv,
                                             torch.as_tensor(seq),
                                             **case.kwargs), want)
    _check(case, ring_decode_ref(tq, tk, tv, torch.as_tensor(seq),
                                 window=case.window, softcap=case.softcap),
           want)


def test_decode_cases_cover_the_serve_shapes():
    """gemma3-1b's local ring (512 slots, part full and wrapped, also at
    batch 1), a global cache whose last block is ragged, the serve path's
    1,024-slot global cache at batch 4 with whole splits past seq_len, a
    batch of 4, and the reference's whole kernel-test grid."""
    names = {c.name for c in DECODE_CASES}
    assert len(names) == len(DECODE_CASES) == 24
    g3 = [c for c in DECODE_CASES if (c.q_heads, c.kv_heads, c.head_dim)
          == (4, 1, 256)]
    assert {(c.window, c.dtype) for c in g3} >= {(512, "bfloat16"),
                                                 (1000, "bfloat16"),
                                                 (1000, "float32")}
    assert any(c.seq_len > c.window for c in g3)
    assert any(c.window % c.block for c in g3)
    assert any(c.batch == 4 for c in g3)
    assert any(c.batch == 1 and c.window == 512 and c.dtype == "bfloat16"
               for c in g3)
    assert any(c.batch == 4 and c.window == 1024 and c.seq_len < 1024
               for c in g3)
    assert sum(c.name.startswith("decode_q") for c in DECODE_CASES) == 15


@pytest.mark.parametrize("qh,kvh,dh,window,block", [
    (8, 2, 64, 256, 64), (4, 4, 128, 128, 128), (16, 1, 64, 512, 128),
])
@pytest.mark.parametrize("T", [7, 100, 256, 512, 5000])
def test_ops_decode_attention_matches_reference_ops(qh, kvh, dh, window,
                                                     block, T):
    if T > window and T % window == 0:
        T += 1
    case = DecodeCase("ops", qh, kvh, dh, window, block, T)
    q, k, v, _ = decode_inputs(case, seed=1)
    want = np.asarray(ref_ops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), T, window=window,
        block=block))
    got = ops.decode_attention(*_torch(case, (q, k, v)), T, window=window,
                               block=block)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_ops_block_must_divide_window():
    case = DecodeCase("div", 4, 1, 256, 1000, 128, 700)
    q, k, v, seq = decode_inputs(case)
    with pytest.raises(ValueError, match="block must divide window"):
        ref_ops.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), seq, window=1000, block=128)
    with pytest.raises(ValueError, match="block must divide window"):
        ops.decode_attention(*_torch(case, (q, k, v)), seq, window=1000,
                             block=128)
    # the kernel module's versions take a ragged last block
    out = ring_decode_attention_plain(*_torch(case, (q, k, v)), seq,
                                      window=1000, block=128)
    assert out.shape == (4, 256)


def test_ring_cache_update_is_modular_as_the_reference():
    """RAMStore-with-modulo: after 19 writes slot s holds the largest
    token t < 19 with t % 8 == s, as the reference's (which returns new
    arrays where the port writes in place)."""
    window, kvh, dh = 8, 2, 4
    k_ring = torch.zeros((window, kvh, dh))
    v_ring = torch.zeros((window, kvh, dh))
    rk, rv = jnp.zeros((window, kvh, dh)), jnp.zeros((window, kvh, dh))
    for t in range(19):
        kn = torch.full((kvh, dh), float(t))
        out = ring_cache_update(k_ring, v_ring, kn, -kn, t)
        assert out[0] is k_ring and out[1] is v_ring
        rk, rv = ref_cache_update(rk, rv, jnp.full((kvh, dh), float(t)),
                                  jnp.full((kvh, dh), -float(t)),
                                  jnp.asarray(t))
    for s in range(window):
        expect = s + 16 if s + 16 < 19 else s + 8
        assert float(k_ring[s, 0, 0]) == expect == -float(v_ring[s, 0, 0])
    np.testing.assert_array_equal(k_ring.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(v_ring.numpy(), np.asarray(rv))


def test_seq_len_forms_agree():
    """An int, a 0-d tensor and one entry per row give the same output."""
    case = DecodeCase("forms", 8, 2, 64, 256, 64, 300, batch=3)
    q, k, v, _ = decode_inputs(case)
    tq, tk, tv = _torch(case, (q, k, v))
    a = ring_decode_attention_plain(tq, tk, tv, 300, **case.kwargs)
    b = ring_decode_attention_plain(tq, tk, tv, torch.tensor(300),
                                    **case.kwargs)
    c = ring_decode_attention_plain(tq, tk, tv, torch.full((3,), 300),
                                    **case.kwargs)
    assert torch.equal(a, b) and torch.equal(a, c)
    with pytest.raises(ValueError, match="seq_len"):
        ring_decode_attention_plain(tq, tk, tv, torch.full((2,), 300),
                                    **case.kwargs)


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_shapes():
    """The CUDA wrapper launches or raises: on CPU tensors it raises (the
    CPU path is the plain version) and it never counts a launch."""
    case = DecodeCase("cpu", 4, 1, 256, 512, 128, 300)
    q, k, v, _ = decode_inputs(case)
    tq, tk, tv = _torch(case, (q, k, v))
    before = ring_decode_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        ring_decode_attention(tq, tk, tv, 300, window=512)
    with pytest.raises(ValueError, match="slots"):
        ring_decode_attention(tq, tk, tv, 300, window=256)
    k2 = torch.zeros((512, 2, 256))
    with pytest.raises(ValueError, match="multiple"):
        ring_decode_attention(tq[:3], k2, k2, 300, window=512)
    with pytest.raises(ValueError, match="q_heads"):
        ring_decode_attention(tq[None], tk, tv, 300, window=512)
    assert ring_decode_attention.launches == before
    assert KERNELS["ring_decode_attention"] is ring_decode_attention
    assert PLAIN["ring_decode_attention"] is ring_decode_attention_plain
    # gemma3-1b's serve shape fits easily: 4 q rows of 256 and a 4 x 128
    # score tile
    assert decode_smem(4, 256, 128) == 4 * (1024 + 512 + 12)


def test_bf16_ulp():
    assert bf16_ulp(1.0) == 2.0 ** -7
    assert bf16_ulp(3.9) == 2.0 ** -6
    assert bf16_ulp(0.5) == 2.0 ** -8
