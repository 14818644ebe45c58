"""Ring KV-cache decode attention: CUDA wrapper, plain version, oracle and
the ring slot write.

Counterpart of :mod:`repro.kernels.ring_decode`.  A sliding-window KV
cache is a vMCU segment ring: slot ``t % window`` holds token ``t``'s
K/V, the write pointer advances modulo the window, and a slot is valid
where ``slot < seq_len`` or the ring has wrapped (``seq_len >= window``).
A global layer's cache of ``cache_len`` slots is the same ring with
``window = cache_len``: it never wraps, so the rule reduces to
``slot < seq_len``.

:func:`ring_decode_attention` replaces the Pallas kernel
(``src/repro/kernels/ring_decode.py:77``).  It takes the reference's
layout, q ``[q_heads, d]`` and k/v ``[window, kv_heads, d]``, or a batch
of them, q ``[B, q_heads, d]`` and k/v ``[B, window, kv_heads, d]``, and
``seq_len`` as an int, a 0-d tensor or one int per batch row.  It checks
its arguments and launches the hand-written kernels of
``csrc/ring_decode.cu`` on the current CUDA stream without
synchronising; it raises for a tensor that is not on a CUDA card and
never falls back to its plain version.  The kernel splits the window
across CTAs (:func:`decode_splits`): each CTA walks its range of slots
in blocks of at most ``block`` slots and writes a partial softmax to a
workspace, and a second kernel combines the partials; the wrapper call
counts as one launch in ``ring_decode_attention.launches``.  A range
shorter than ``block`` holds only the slots that exist, so any window (a
global cache of any ``cache_len``) is taken.

``return_lse=True`` (both versions) also returns each q row's
log-sum-exp of its valid scores, ``[B, q_heads]`` fp32, so that ranks
that each hold a slice of a cache can combine their partial attentions;
a row whose slice holds no valid slot yet (``seq_len < 1``) is then
empty, ``out = 0`` and ``lse = -inf``, instead of the uniform average
over the window that an empty cache gives without it.

:func:`ring_decode_attention_plain` is the plain version: the Pallas
body's block-by-block online softmax in PyTorch, batched.
:func:`ring_decode_ref` is the port of ``repro.kernels.ref.
ring_decode_ref`` (an exact softmax over the whole window), and
:func:`ring_cache_update` of the reference's modulo-slot write.
"""
from __future__ import annotations

import dataclasses
import functools
import threading

import torch

from ._launch import MAX_SMEM, launch
from .conv2d import H100_SMS, _sm_count

F32 = torch.float32
#: Masked scores, as the Pallas kernel's ``NEG_INF``.
NEG_INF = -1e30
#: What the kernel takes: q heads per kv head, and head_dim (a power of
#: two up to 256, so that it divides the block's 256 threads).
MAX_GROUP = 16
MAX_HEAD_DIM = 256
DTYPES = (torch.float32, torch.bfloat16)
#: Slots a split's length is a multiple of: two for each of the kernel's
#: 8 warps (8-slot sub-blocks were slower on the card at batch 1, their
#: many splits costing the combine more than the shorter walk saved).
SPLIT_SLOTS = 16


def _batched(q, k_ring, v_ring):
    """``(q, k, v, unbatched)`` with a leading batch dimension."""
    if q.ndim == 2 and k_ring.ndim == 3 and v_ring.ndim == 3:
        return q[None], k_ring[None], v_ring[None], True
    if q.ndim == 3 and k_ring.ndim == 4 and v_ring.ndim == 4:
        return q, k_ring, v_ring, False
    raise ValueError("q [q_heads, d] with k/v [window, kv_heads, d], or q "
                     "[B, q_heads, d] with k/v [B, window, kv_heads, d]; got "
                     f"{tuple(q.shape)}, {tuple(k_ring.shape)}, "
                     f"{tuple(v_ring.shape)}")


def _check(q, k, v, window: int, block: int) -> int:
    """The GQA group, after the shape checks every version makes."""
    B, q_heads, d = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)}, {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.shape[1] != window or window < 1:
        raise ValueError(f"the ring holds {k.shape[1]} slots, not window "
                         f"{window}")
    if block < 1:
        raise ValueError("block must be >= 1")
    kv_heads = k.shape[2]
    if kv_heads < 1 or q_heads % kv_heads:
        raise ValueError(f"{q_heads} q heads are no multiple of {kv_heads} "
                         "kv heads")
    return q_heads // kv_heads


def _seq_rows(seq_len, B: int, device) -> torch.Tensor:
    """``seq_len`` as one int64 per batch row on ``device``."""
    s = torch.as_tensor(seq_len, device=device).to(torch.int64)
    if s.ndim == 0:
        return s.expand(B)
    if s.shape != (B,):
        raise ValueError(f"seq_len must be a scalar or [{B}], got "
                         f"{tuple(s.shape)}")
    return s


def decode_smem(group: int, d: int, block: int) -> int:
    """Shared memory of one CTA of the kernel: the group's scaled q
    rows, a ``[group, block]`` score tile and three floats per q row."""
    return 4 * (group * d + group * block + 3 * group)


@dataclasses.dataclass(frozen=True)
class DecodeSplits:
    """How :func:`ring_decode_attention` splits a ``window``-slot ring
    across CTAs: split z holds slots ``z * split_len ..`` (fewer in the
    last), and the grid is one CTA per (kv head, batch row, split)."""

    batch: int
    kv_heads: int
    window: int
    split_len: int

    @property
    def splits(self) -> int:
        return -(-self.window // self.split_len)

    @property
    def ctas(self) -> int:
        return self.batch * self.kv_heads * self.splits

    def split(self, z: int) -> tuple[int, int]:
        """Split ``z``'s slots ``(s0, n)``: ``s0 .. s0 + n - 1``."""
        s0 = z * self.split_len
        return s0, min(self.split_len, self.window - s0)


@functools.lru_cache(maxsize=4096)
def decode_splits(batch: int, kv_heads: int, window: int,
                  n_sm: int = H100_SMS) -> DecodeSplits:
    """The split of a ``window``-slot ring for ``batch`` rows of
    ``kv_heads`` kv heads on ``n_sm`` SMs: ``ceil(n_sm / (batch *
    kv_heads))`` splits per (kv head, batch row) would put one CTA on
    each SM; the split length is the window over that, rounded up to a
    whole number of ``SPLIT_SLOTS``-slot sub-blocks, so the CTAs come to
    at most about one per SM (fewer where a short window runs out of
    sub-blocks; one split where the rows alone fill the card)."""
    want = -(-n_sm // (batch * kv_heads))
    split_len = -(-window // want)
    split_len = -(-split_len // SPLIT_SLOTS) * SPLIT_SLOTS
    return DecodeSplits(batch, kv_heads, window, split_len)


def _check_cuda(q, k, v) -> None:
    """The kernel's device, dtype and contiguity rules."""
    for name, t in (("q", q), ("k_ring", k), ("v_ring", v)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError("ring_decode_attention runs on CUDA tensors "
                             f"only; {name} is on "
                             f"{getattr(t, 'device', type(t))} (the CPU "
                             "path uses ring_decode_attention_plain)")
        if t.device != q.device or t.dtype != q.dtype \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {q.dtype} tensor "
                             f"on {q.device}")
    if q.dtype not in DTYPES:
        raise ValueError(f"the kernel takes {DTYPES}, not {q.dtype}")


def ring_decode_attention(q, k_ring, v_ring, seq_len, *, window: int,
                          block: int = 128, softcap: float | None = None,
                          return_lse: bool = False):
    """One decode step of attention over a ring KV cache on the card
    (replaces ``ring_decode_attention``,
    ``src/repro/kernels/ring_decode.py:77``); returns q's shape and
    dtype, and with ``return_lse`` also the rows' log-sum-exp (``[B,
    q_heads]``, or ``[q_heads]`` unbatched; fp32), empty rows at
    ``seq_len < 1`` giving 0 and ``-inf``."""
    q, k, v, unbatched = _batched(q, k_ring, v_ring)
    group = _check(q, k, v, window, block)
    B, q_heads, d = q.shape
    _check_cuda(q, k, v)
    if group > MAX_GROUP or d > MAX_HEAD_DIM or d & (d - 1):
        raise ValueError(f"the kernel takes up to {MAX_GROUP} q heads per kv "
                         f"head and a power-of-two head_dim up to "
                         f"{MAX_HEAD_DIM}; got group {group}, head_dim {d}")
    smem = decode_smem(group, d, block)
    if smem > MAX_SMEM:
        raise ValueError(f"block {block} needs {smem} B of shared memory, "
                         f"above the card's {MAX_SMEM} B")
    seq_rows, seq_scalar = None, 0
    if isinstance(seq_len, torch.Tensor) and seq_len.device.type == "cuda":
        seq_rows = _seq_rows(seq_len, B, q.device).to(torch.int32) \
            .contiguous()
    else:
        s = torch.as_tensor(seq_len)
        if s.ndim:
            seq_rows = _seq_rows(s, B, "cpu").to(torch.int32).to(q.device)
        else:
            seq_scalar = int(s)
    kv_heads = k.shape[2]
    sp = decode_splits(B, kv_heads, window, _sm_count(q.device))
    out = torch.empty_like(q)
    # the splits' partials: (m, l) per q row, then acc [group, d], fp32;
    # then, with return_lse, the rows' log-sum-exp [B, q_heads]
    work = sp.ctas * group * (d + 2)
    part = torch.empty((work + (B * q_heads if return_lse else 0),),
                       dtype=F32, device=q.device)
    launch("ring_decode_attention", q, smem, (k, v, seq_rows, out, part),
           (B, window, kv_heads, group, d, block, seq_scalar,
            int(q.dtype == torch.bfloat16), sp.split_len, sp.splits,
            d ** -0.5, float(softcap or 0.0), int(return_lse)))
    with _COUNTING:   # the ranks of a one-process mesh launch in threads
        ring_decode_attention.launches += 1
    _THREAD.launches = getattr(_THREAD, "launches", 0) + 1
    if return_lse:
        _THREAD.lse_launches = getattr(_THREAD, "lse_launches", 0) + 1
        lse = part[work:].view(B, q_heads)
        return (out[0], lse[0]) if unbatched else (out, lse)
    return out[0] if unbatched else out


_COUNTING = threading.Lock()
_THREAD = threading.local()


def thread_launches(lse: bool = False) -> int:
    """The launches of :func:`ring_decode_attention` made on this thread
    since it began (a stand-in mesh's rank runs on a thread of its
    own); ``lse``: of them, those with ``return_lse``."""
    return getattr(_THREAD, "lse_launches" if lse else "launches", 0)


def ring_decode_attention_plain(q, k_ring, v_ring, seq_len, *, window: int,
                                block: int = 128,
                                softcap: float | None = None,
                                return_lse: bool = False):
    """Plain version of :func:`ring_decode_attention`: the Pallas body's
    online softmax, block by block, in fp32 (``return_lse`` as there)."""
    q, k, v, unbatched = _batched(q, k_ring, v_ring)
    group = _check(q, k, v, window, block)
    B, q_heads, d = q.shape
    kv_heads = k.shape[2]
    seq = _seq_rows(seq_len, B, q.device)[:, None, None, None]
    qg = q.to(F32).reshape(B, kv_heads, group, d) * (d ** -0.5)
    m = torch.full((B, kv_heads, group), NEG_INF, dtype=F32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, kv_heads, group, d), dtype=F32, device=q.device)
    for base in range(0, window, block):
        kb = k[:, base:base + block].to(F32)          # [B, nb, kv, d]
        s = torch.einsum("bkgd,bskd->bkgs", qg, kb)
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        slot = torch.arange(base, base + kb.shape[1], device=q.device)
        valid = (slot < seq) | (seq >= window)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgs,bskd->bkgd", p, v[:, base:base + block].to(F32))
        m = m_new
    out = (acc / l[..., None]).reshape(B, q_heads, d)
    if not return_lse:
        out = out.to(q.dtype)
        return out[0] if unbatched else out
    lse = (m + torch.log(l)).reshape(B, q_heads)
    empty = (seq < 1).reshape(B, 1)
    out = torch.where(empty[..., None], torch.zeros((), dtype=F32,
                                                    device=q.device), out)
    lse = torch.where(empty, torch.full((), float("-inf"), device=q.device),
                      lse)
    out = out.to(q.dtype)
    return (out[0], lse[0]) if unbatched else (out, lse)


def ring_decode_ref(q, k_ring, v_ring, seq_len, *, window: int,
                    softcap: float | None = None):
    """Oracle decode attention over the whole window with an exact
    softmax (``repro.kernels.ref.ring_decode_ref``), unbatched or
    batched like :func:`ring_decode_attention`."""
    q, k, v, unbatched = _batched(q, k_ring, v_ring)
    group = _check(q, k, v, window, 1)
    B, q_heads, d = q.shape
    kv_heads = k.shape[2]
    qf = q.to(F32).reshape(B, kv_heads, group, d) * (d ** -0.5)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k.to(F32))
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    seq = _seq_rows(seq_len, B, q.device)[:, None, None, None]
    slot = torch.arange(window, device=q.device)
    s = s.masked_fill(~((slot < seq) | (seq >= window)), float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.to(F32))
    out = out.reshape(B, q_heads, d).to(q.dtype)
    return out[0] if unbatched else out


def ring_cache_update(k_ring, v_ring, k_new, v_new, seq_len):
    """Write one token's K/V into ring slot ``seq_len % window`` (the
    paper's RAMStore-with-modulo, ``ring_decode.py:117``): k/v
    ``[window, kv_heads, d]`` and k_new/v_new ``[kv_heads, d]``.  The
    reference returns new arrays; the port writes the slot in place and
    returns the same two tensors."""
    slot = int(seq_len) % k_ring.shape[0]
    k_ring[slot] = k_new.to(k_ring.dtype)
    v_ring[slot] = v_new.to(v_ring.dtype)
    return k_ring, v_ring


KERNELS = {"ring_decode_attention": ring_decode_attention}
PLAIN = {"ring_decode_attention": ring_decode_attention_plain}

ring_decode_attention.launches = 0
ring_decode_attention.weights_staged = None
