"""The port's checkpoints and training loop (``repro_torch.checkpoint``,
``repro_torch.launch.train``) against the reference's, on the CPU:

* the reference's six checkpoint cases (``tests/test_checkpoint.py``) on
  the port's manager;
* the files are interchangeable: a reduced gemma3-1b train state (205
  keys, ``step`` an int32 scalar) written by either package restores
  bit for bit in the other, for a plain and a two-copy state.  The
  reference's ``restore`` cannot read a bf16 leaf (its ``jnp.asarray``
  has no cast from the ``|V2`` payload numpy stores it as), its own
  checkpoint's or the port's; so a two-copy checkpoint of the port is
  held as the same arrays, byte for byte, as the reference writes, and
  the reference restores its fp32 and int32 leaves;
* an async save copies the state before it returns: a change made in
  place before ``wait()`` does not reach the file;
* ``train_loop`` from the reference's initial params: the final loss
  after 10 steps within rtol 2e-2 of the reference's ``train_loop``;
  6 steps, then a resumed run to 10, lands within rtol 1e-5 of an
  unbroken run (the reference's own bound);
* stragglers counted on a scripted clock; preemption raised
  deterministically at a chosen step (no signal is sent); the SIGTERM
  handler after the loop is the one before it.
"""
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.configs import get_config as ref_get_config
from repro.launch.train import train_loop as ref_train_loop
from repro.models.registry import build_model as ref_build_model
from repro.train import optimizer as ref_opt
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.kernels.cases import lm_params
from repro_torch.launch import train as train_mod
from repro_torch.train import init_state
from repro_torch.train.optimizer import TrainState
from repro_torch.train.tree import leaves, unflatten_like

torch.set_num_threads(2)

NAME = "gemma3-1b"
CFG = get_config(NAME).reduced()


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 8), generator=g),
            "nested": {"b": torch.arange(6).reshape(2, 3).float()},
            "groups": (torch.ones((2, 3)), {"c": torch.zeros((5,))})}


def _like(tree):
    return unflatten_like(tree, [torch.empty(t.shape, dtype=t.dtype,
                                             device="meta")
                                 for t in leaves(tree)])


def _equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# -- the reference's six cases ---------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(10, tree)
    _equal(mgr.restore(_like(tree)), tree)


def test_latest_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert mgr.latest_step() == 4
    assert mgr.steps() == [3, 4]


def test_atomic_no_partial_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, _tree())
    os.makedirs(os.path.join(str(tmp_path), "step_0000000009.tmp"))
    assert mgr.latest_step() == 5


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(7, _tree())
    mgr.wait()
    assert mgr.latest_step() == 7


def test_restore_missing_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore(_tree())


def test_elastic_restore_dtype_and_structure(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, _tree(1))
    out = mgr.restore(_like(_tree(99)))
    assert torch.equal(out["a"], _tree(1)["a"])
    assert out["a"].device.type == "cpu"
    assert isinstance(out["groups"], tuple)


# -- interchangeable files ----------------------------------------------------

def _states(two_copy: bool):
    """The same reduced gemma3-1b train state in both packages: the
    params of lm_params, seeded moments, step 7."""
    tree = lm_params(CFG, 0)
    rng = np.random.default_rng(5)
    mu = unflatten_like(tree, [rng.standard_normal(a.shape).astype(
        np.float32) for a in leaves(tree)])
    nu = unflatten_like(tree, [np.abs(a) for a in leaves(mu)])

    def th(t):
        return unflatten_like(t, [torch.tensor(a) for a in leaves(t)])
    ref = ref_opt.init_state(jax.tree.map(jnp.asarray, tree),
                             two_copy=two_copy)
    ref = ref._replace(step=jnp.asarray(7, jnp.int32),
                       mu=jax.tree.map(jnp.asarray, mu),
                       nu=jax.tree.map(jnp.asarray, nu))
    port = init_state(th(tree), two_copy=two_copy)
    port = port._replace(step=torch.tensor(7, dtype=torch.int32),
                         mu=th(mu), nu=th(nu))
    return ref, port


def _bits(x) -> np.ndarray:
    """The raw bytes of a jax array or tensor as a flat uint8 array."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().reshape(-1).view(np.uint8)
    return np.asarray(x).reshape(-1).view(np.uint8)


def _shard(directory, step) -> dict:
    path = os.path.join(str(directory), f"step_{step:010d}",
                        "shard_00000.npz")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("two_copy", [False, True])
def test_a_reference_checkpoint_restores_bitwise_in_the_port(tmp_path,
                                                             two_copy):
    ref, port = _states(two_copy)
    RefManager(str(tmp_path)).save(7, ref)
    out = CheckpointManager(str(tmp_path)).restore(_like(port))
    assert isinstance(out, TrainState)
    assert out.step.dtype == torch.int32 and out.step.shape == ()
    assert len(_shard(tmp_path, 7)) == (205 if not two_copy else 273)
    want = jax.tree.leaves(ref)
    got = leaves(out)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))
    if two_copy:
        assert all(c.dtype == torch.bfloat16 for c in leaves(out.cast))


@pytest.mark.parametrize("two_copy", [False, True])
def test_a_port_checkpoint_restores_bitwise_in_the_reference(tmp_path,
                                                             two_copy):
    ref, port = _states(two_copy)
    CheckpointManager(str(tmp_path / "port")).save(7, port)
    RefManager(str(tmp_path / "ref")).save(7, ref)
    have, want = _shard(tmp_path / "port", 7), _shard(tmp_path / "ref", 7)
    assert sorted(have) == sorted(want)
    assert "step" in have and have["step"].dtype == np.int32
    for k in want:
        assert have[k].dtype == want[k].dtype and \
            have[k].shape == want[k].shape, k
        assert have[k].tobytes() == want[k].tobytes(), k
    mgr = RefManager(str(tmp_path / "port"))
    like = jax.eval_shape(lambda: ref._replace(cast=None))
    out = mgr.restore(like)
    for g, w in zip(jax.tree.leaves(out), jax.tree.leaves(ref._replace(
            cast=None))):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(_bits(g), _bits(w))
    if two_copy:   # the reference reads no bf16 leaf, its own neither
        for d in ("port", "ref"):
            with pytest.raises(ValueError):
                RefManager(str(tmp_path / d)).restore(jax.eval_shape(
                    lambda: ref))


def test_an_async_save_snapshots_before_it_returns(tmp_path):
    _, state = _states(True)
    before = [t.clone() for t in leaves(state)]
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(7, state)
    for t in leaves(state):   # what the next in-place step does
        t.add_(1)
    mgr.wait()
    out = mgr.restore(_like(state))
    for g, w in zip(leaves(out), before):
        assert torch.equal(g, w)


def test_restore_places_leaves_on_the_device_asked(tmp_path):
    _, state = _states(False)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, state)
    out = mgr.restore(_like(state), device="cpu")
    assert {t.device.type for t in leaves(out)} == {"cpu"}
    # a shardings tree that places no leaf restores every leaf as above
    bare = mgr.restore(_like(state), shardings={}, device="cpu")
    assert all(type(g) is torch.Tensor and torch.equal(g, w)
               for g, w in zip(leaves(bare), leaves(out)))


# -- the training loop ----------------------------------------------------------

def _ref_init_params():
    """The reference train_loop's initial params, as numpy."""
    model = ref_build_model(ref_get_config(NAME).reduced())
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))


def test_train_loop_matches_the_references(tmp_path):
    kw = dict(steps=10, batch=2, seq=16, ckpt_every=100, log_every=100)
    want = ref_train_loop(ref_get_config(NAME).reduced(),
                          ckpt_dir=str(tmp_path / "ref"), **kw)
    got = train_mod.train_loop(CFG, ckpt_dir=str(tmp_path / "port"),
                               device="cpu", params=_ref_init_params(), **kw)
    np.testing.assert_allclose(got["first_loss"], want["first_loss"],
                               rtol=1e-2)
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=2e-2)
    assert got["final_loss"] < got["first_loss"]


def test_restart_is_deterministic(tmp_path):
    """Stop after 6 steps, resume to 10, and land on the loss of an
    unbroken run."""
    kw = dict(batch=2, seq=16, log_every=100, device="cpu")
    full = train_mod.train_loop(CFG, steps=10, ckpt_dir=str(tmp_path / "a"),
                                ckpt_every=100, **kw)
    train_mod.train_loop(CFG, steps=6, ckpt_dir=str(tmp_path / "b"),
                         ckpt_every=3, **kw)
    resumed = train_mod.train_loop(CFG, steps=10,
                                   ckpt_dir=str(tmp_path / "b"),
                                   ckpt_every=100, **kw)
    np.testing.assert_allclose(resumed["final_loss"], full["final_loss"],
                               rtol=1e-5)
    assert CheckpointManager(str(tmp_path / "b")).latest_step() == 10


class _Clock:
    """``time.time`` of a script: each call returns the next reading."""

    def __init__(self, step_seconds):
        self.readings = []
        t = 0.0
        for dt in step_seconds:
            self.readings += [t, t + dt]
            t += dt + 1.0
        self.readings.reverse()

    def time(self):
        return self.readings.pop()


def test_stragglers_are_counted(tmp_path, monkeypatch):
    """A step over 3x the median of the steps so far counts, once more
    than 8 steps are in."""
    seconds = [1.0] * 9 + [5.0, 1.0, 2.9]
    monkeypatch.setattr(train_mod, "time", _Clock(seconds))
    out = train_mod.train_loop(CFG, steps=12, batch=1, seq=8,
                               ckpt_dir=str(tmp_path), ckpt_every=100,
                               log_every=100, device="cpu")
    assert out["stragglers"] == 1
    assert out["median_step_s"] == 1.0


def test_preemption_checkpoints_and_stops(tmp_path, monkeypatch):
    """The flag raised at step 3 (as SIGTERM's handler raises it): the
    loop checkpoints at step 4 and stops; the handler is installed while
    it runs and the previous one is back after."""
    seen = []
    real = train_mod.synthetic_batch

    def batch_at(cfg, batch, seq, step, **kw):
        seen.append((step, signal.getsignal(signal.SIGTERM)))
        if step == 3:
            train_mod._PREEMPTED = True
        return real(cfg, batch, seq, step, **kw)

    def before(signum, frame):  # noqa: ANN001
        pass

    monkeypatch.setattr(train_mod, "_PREEMPTED", False)
    monkeypatch.setattr(train_mod, "synthetic_batch", batch_at)
    previous = signal.signal(signal.SIGTERM, before)
    try:
        train_mod.train_loop(CFG, steps=10, batch=1, seq=8,
                             ckpt_dir=str(tmp_path), ckpt_every=100,
                             log_every=100, device="cpu")
        assert signal.getsignal(signal.SIGTERM) is before
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert [s for s, _ in seen] == [0, 1, 2, 3]
    assert all(h is train_mod._on_sigterm for _, h in seen)
    assert CheckpointManager(str(tmp_path)).steps() == [4]


def test_the_command_trains_on_the_cpu(tmp_path, capsys):
    train_mod.main(["--arch", NAME, "--reduced", "--device", "cpu",
                    "--steps", "2", "--batch", "1", "--seq", "8",
                    "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "'final_loss'" in out
    assert CheckpointManager(str(tmp_path)).latest_step() == 2


def test_the_command_checkpoints_under_tmp_by_default():
    """As the reference's: a run from a checkout writes nothing into it."""
    args = train_mod.build_parser().parse_args(["--arch", NAME])
    assert args.ckpt_dir == "/tmp/repro_ckpt"
