"""The split of the decode attention's window across CTAs, on the CPU.

``ring_decode_attention`` (``csrc/ring_decode.cu``) runs one CTA per (kv
head, batch row, split) of
``repro_torch.kernels.ring_decode.decode_splits``: each runs the online
softmax over its own contiguous range of slots and writes a partial (m,
l, acc) to a workspace, and a combine kernel rescales each split by
exp(m_i - M) and divides once.  Held here:

* every slot lies in exactly one split, the split length is a whole
  number of ``SPLIT_SLOTS``-slot sub-blocks, and the CTA count is the
  one stated (gemma3-1b's serve shapes: 128 CTAs at batch 4, more than
  B x kv_heads);
* a model of the kernels' arithmetic (the splits, the skipped ones past
  seq_len, the combine) against the port's oracle ``ring_decode_ref``
  and the plain version on every ``DECODE_CASES`` entry and the other
  block kinds' LM geometries (``LM_DECODE_CASES``), at
  ``compare_decode``'s tolerance (fp32 2e-5, bf16 one ulp of the
  output's scale), and against the plain version where seq_len < 1
  averages the whole window;
* the wrapper's launch arguments (splits, workspace, counts).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ring_decode as rd
from repro_torch.kernels.cases import (DECODE_CASES, LM_DECODE_CASES,
                                       DecodeCase, compare_decode,
                                       decode_inputs)
from repro_torch.kernels.ring_decode import (SPLIT_SLOTS, decode_splits,
                                             ring_decode_attention_plain,
                                             ring_decode_ref)

F32 = torch.float32
NEG_INF = rd.NEG_INF

torch.set_num_threads(2)


def _rows(case) -> int:
    return case.batch or 1


GEOMETRIES = sorted({(_rows(c), c.kv_heads, c.window)
                     for c in DECODE_CASES + LM_DECODE_CASES}
                    | {(4, 1, 512), (4, 1, 1024), (1, 1, 512),
                       (1, 1, 1024), (8, 1, 5), (200, 1, 64)})


@pytest.mark.parametrize("n_sm", (132, 114, 16))
@pytest.mark.parametrize("geom", GEOMETRIES, ids=str)
def test_every_slot_is_in_exactly_one_split(geom, n_sm):
    B, kv, window = geom
    sp = decode_splits(B, kv, window, n_sm)
    assert sp.split_len % SPLIT_SLOTS == 0
    assert sp.ctas == B * kv * sp.splits
    seen = np.zeros(window, int)
    for z in range(sp.splits):
        s0, n = sp.split(z)
        assert 1 <= n <= sp.split_len
        seen[s0:s0 + n] += 1
    assert (seen == 1).all()
    # at most about one CTA an SM: one split fewer would not cover
    assert sp.splits == 1 or sp.splits <= -(-n_sm // (B * kv))


@pytest.mark.parametrize("geom, ctas, split_len", [
    ((4, 1, 512), 128, 16), ((4, 1, 1024), 128, 32), ((1, 1, 512), 32, 16),
    ((1, 1, 1024), 64, 16), ((200, 1, 64), 200, 64)], ids=str)
def test_the_cta_count_is_as_stated(geom, ctas, split_len):
    """gemma3-1b's serve shapes at batch 4 run 128 CTAs, not 4; at batch 1
    a 512-slot ring runs out of 16-slot sub-blocks at 32; a batch that
    fills the card alone keeps one split."""
    sp = decode_splits(*geom)
    assert (sp.ctas, sp.split_len) == (ctas, split_len)
    B, kv, _ = geom
    assert sp.ctas > B * kv or B * kv >= 132


# ---------------------------------------------------------------------------
# A model of the kernels' arithmetic.
# ---------------------------------------------------------------------------

def _split_model(q, k, v, seq, *, window, block, softcap, sp):
    """The split kernel and the combine, in fp32, batched: q [B, Hq, d],
    k/v [B, window, kv, d], seq one int per row."""
    B, q_heads, d = q.shape
    kv = k.shape[2]
    group = q_heads // kv
    out = torch.empty((B, kv, group, d), dtype=F32)
    qg = q.to(F32).reshape(B, kv, group, d) * (d ** -0.5)
    for b in range(B):
        s = int(seq[b])
        end = window if s >= window or s < 1 else s
        parts = []
        for z in range(sp.splits):
            s0 = z * sp.split_len
            if s0 >= end:                # wholly past seq: skipped
                continue
            s1 = min(s0 + sp.split_len, end)
            m = torch.full((kv, group), NEG_INF, dtype=F32)
            l = torch.zeros((kv, group), dtype=F32)
            acc = torch.zeros((kv, group, d), dtype=F32)
            for base in range(s0, s1, block):
                top = min(base + block, s1)
                kb = k[b, base:top].to(F32)                    # [nb, kv, d]
                x = torch.einsum("kgd,skd->kgs", qg[b], kb)
                if softcap is not None:
                    x = torch.tanh(x / softcap) * softcap
                slot = torch.arange(base, top)
                x = torch.where((slot < s) | (s >= window), x,
                                torch.full_like(x, NEG_INF))
                m_new = torch.maximum(m, x.amax(-1))
                p = torch.exp(x - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "kgs,skd->kgd", p, v[b, base:top].to(F32))
                m = m_new
            parts.append((m, l, acc))
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        w = [torch.exp(m - mx) for m, _, _ in parts]
        L = sum(l * wi for (_, l, _), wi in zip(parts, w))
        o = sum(acc * wi[..., None] for (_, _, acc), wi in zip(parts, w))
        out[b] = o / L[..., None]
    return out.reshape(B, q_heads, d).to(q.dtype)


def _inputs(case):
    q, k, v, seq = decode_inputs(case)
    dt = getattr(torch, case.dtype)
    tq, tk, tv = (torch.from_numpy(a).to(dt) for a in (q, k, v))
    if not case.batch:
        tq, tk, tv = tq[None], tk[None], tv[None]
    seqs = np.array(np.broadcast_to(np.asarray(seq), (_rows(case),)))
    return tq, tk, tv, seqs


def _model(case, tq, tk, tv, seqs, n_sm=132):
    sp = decode_splits(_rows(case), case.kv_heads, case.window, n_sm)
    return _split_model(tq, tk, tv, seqs, window=case.window,
                        block=case.block, softcap=case.softcap, sp=sp)


@pytest.mark.parametrize("case", DECODE_CASES + LM_DECODE_CASES,
                         ids=lambda c: c.name)
def test_split_model_matches_oracle_and_plain(case):
    tq, tk, tv, seqs = _inputs(case)
    got = _model(case, tq, tk, tv, seqs).float().numpy()
    seq = torch.from_numpy(seqs)
    want = ring_decode_ref(tq, tk, tv, seq, window=case.window,
                           softcap=case.softcap).float().numpy()
    err, bad = compare_decode(got, want, case.dtype)
    assert bad is None, f"against the oracle: {bad} ({err:.3g})"
    plain = ring_decode_attention_plain(tq, tk, tv, seq, **case.kwargs)
    err, bad = compare_decode(got, plain.float().numpy(), case.dtype)
    assert bad is None, f"against the plain version: {bad} ({err:.3g})"


def test_split_model_averages_the_window_when_nothing_is_valid():
    """seq_len 0: every score is masked at -1e30, every split weighs in
    with exp(0), and the whole window is averaged, as the plain version
    does; seq_len 5 skips all but the first split."""
    case = DecodeCase("empty", 4, 1, 64, 256, 64, (0, 5, 256, 300),
                      batch=4)
    tq, tk, tv, seqs = _inputs(case)
    for n_sm in (132, 16):
        got = _model(case, tq, tk, tv, seqs, n_sm)
        want = ring_decode_attention_plain(
            tq, tk, tv, torch.from_numpy(seqs),
            **case.kwargs)
        err, bad = compare_decode(got.numpy(), want.numpy(), case.dtype)
        assert bad is None, (n_sm, bad, err)
    mean = tv[0].to(F32).mean(0)                       # [kv, d]
    assert torch.allclose(got[0], mean.expand(4, 64), atol=1e-5)


@pytest.mark.parametrize("case", [
    c for c in DECODE_CASES if c.name in (
        "decode_gemma3_batch4_bf16", "decode_gemma3_local_batch1_bf16",
        "decode_gemma3_global_1024_batch4_bf16", "decode_batch4_per_row_seq",
        "decode_q16_kv1_d64_w512_b128_T7")] + list(LM_DECODE_CASES),
    ids=lambda c: c.name)
def test_wrapper_launch_arguments(case, monkeypatch):
    calls = []
    monkeypatch.setattr(rd, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(rd, "_sm_count", lambda device: 132)
    monkeypatch.setattr(rd, "launch",
                        lambda name, q, smem, tensors, ints:
                        calls.append((name, q, smem, tensors, ints)))
    monkeypatch.setattr(rd.ring_decode_attention, "launches", 0)
    q, k, v, seq = decode_inputs(case)
    dt = getattr(torch, case.dtype)
    tq, tk, tv = (torch.from_numpy(a).to(dt) for a in (q, k, v))
    s = seq if isinstance(seq, int) else torch.from_numpy(seq)
    rd.ring_decode_attention(tq, tk, tv, s, **case.kwargs)
    [(name, q0, smem, tensors, ints)] = calls
    B = _rows(case)
    group, d = case.q_heads // case.kv_heads, case.head_dim
    sp = decode_splits(B, case.kv_heads, case.window)
    assert name == "ring_decode_attention"
    assert smem == rd.decode_smem(group, d, case.block)
    k0, v0, seq_rows, out, part = tensors
    assert out.shape == (B, case.q_heads, d) and out.dtype == dt
    assert part.dtype == F32 and part.numel() == sp.ctas * group * (d + 2)
    assert (seq_rows is None) == isinstance(seq, int)
    assert ints[:7] == (B, case.window, case.kv_heads, group, d, case.block,
                        seq if isinstance(seq, int) else 0)
    assert ints[7:10] == (int(case.dtype == "bfloat16"), sp.split_len,
                          sp.splits)
    assert ints[10] == d ** -0.5 and ints[11] == (case.softcap or 0.0)
    assert rd.ring_decode_attention.launches == 1
    if (B, case.kv_heads, case.window) in ((4, 1, 512), (4, 1, 1024)):
        assert sp.ctas == 128 > B * case.kv_heads
