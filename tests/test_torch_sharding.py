"""The port's sharding rules (``repro_torch.parallel.sharding``), its
``make_rules`` (``launch/specs.py``) and the production mesh's shape
(``launch/mesh.py``) against the reference's, on the CPU.

No test here opens a process group: the rules are pure, and where one
needs a mesh it gets a stand-in with the ``DeviceMesh`` attributes the
rules read (axis names, shape, this rank's coordinate).

* ``spec`` of every logical name under both modes and every flag
  (``multi_pod``, ``decode``, ``long_context``, ``kv_shardable``,
  ``sp_residual``) equals the reference's ``PartitionSpec`` as a tuple;
  an unknown name raises ``ValueError`` in both;
* ``param_spec`` of every leaf of all ten reduced archs' params trees
  (``Model.init`` on ``meta`` against ``jax.eval_shape``) equals the
  reference's, on the same path strings;
* ``make_rules`` sets the reference's flags for the four shape cells at
  ``model`` sizes 1, 2 and 4;
* ``placements`` cuts a tuple entry data-major, as JAX does: every
  rank's ``local_slices`` is its block of the whole array;
* the production mesh's shape and axis names are the reference's;
* ``check_executable`` takes sequence parallelism (an ``fsdp_sp``
  config over a ``model`` axis above 1), a ``tp`` config over a
  ``model`` axis and an MoE config under a batch axis above 1, and
  refuses, naming the ROADMAP item, an MoE block over a split sequence
  (no config has one).
"""
import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, Mesh

import repro.launch.mesh as ref_mesh
from repro.configs import ARCH_REGISTRY as REF_ARCHS
from repro.launch.specs import make_rules as ref_make_rules
from repro.models.registry import build_model as ref_build_model
from repro.parallel.sharding import AxisRules as RefAxisRules
from repro_torch.configs import ARCH_REGISTRY, get_config
from repro_torch.configs.base import (DECODE_32K, LONG_500K, PREFILL_32K,
                                      TRAIN_4K)
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.launch.specs import make_rules
from repro_torch.models import build_model
from repro_torch.parallel.sharding import (MODEL_AXIS_ITEM, AxisRules,
                                           check_executable, local_slices,
                                           no_sharding)
from repro_torch.train.tree import leaves_with_paths

NAMES = (None, "batch", "fsdp", "seq", "res_seq", "kv_seq", "kv_heads",
         "heads", "ff", "experts", "tp", "vocab")
FLAGS = ("multi_pod", "decode", "long_context", "kv_shardable",
         "sp_residual")
CELLS = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


class FakeMesh:
    """The attributes of a ``DeviceMesh`` the rules read, and a
    coordinate this test sets."""

    def __init__(self, names, shape, coord=None):
        self.mesh_dim_names = tuple(names)
        self.shape = tuple(shape)
        self.ndim = len(shape)
        self.coord = coord

    def get_coordinate(self):
        return list(self.coord)


def _ref_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _fields(rules) -> dict:
    return {f: getattr(rules, f) for f in ("mode",) + FLAGS}


@pytest.mark.parametrize("mode", ["tp", "fsdp_sp"])
@pytest.mark.parametrize("flags", list(itertools.product([False, True],
                                                         repeat=len(FLAGS))),
                         ids=lambda f: "".join("01"[x] for x in f))
def test_spec_of_every_name_is_the_references(mode, flags):
    kw = dict(zip(FLAGS, flags), mode=mode)
    ours = AxisRules(mesh=None, **kw)
    ref = RefAxisRules(mesh=_ref_mesh(), **kw)
    for name in NAMES:
        assert ours.spec(name) == tuple(ref.spec(name)), name
    assert ours.spec(*NAMES) == tuple(ref.spec(*NAMES))


def test_an_unknown_name_raises_in_both():
    with pytest.raises(ValueError, match="unknown logical axis"):
        RefAxisRules(mesh=None).spec("rows")
    with pytest.raises(ValueError, match="unknown logical axis"):
        AxisRules(mesh=None).spec("rows")


def test_without_a_mesh_every_call_is_a_no_op():
    rules = no_sharding()
    x = torch.ones(4, 4)
    assert rules.act(x, "batch", None) is x
    assert rules.sharding("batch") is None
    assert rules.gather({"w": x})["w"] is x
    assert rules.batch_shards() == 1
    assert rules.params_shardings({"a": {"w": x}}) == {"a": {"w": None}}
    assert rules.constrain_tree({"w": x})["w"] is x
    rules.check(get_config("granite-moe-1b-a400m").reduced())


@pytest.mark.parametrize("mode", ["tp", "fsdp_sp"])
@pytest.mark.parametrize("arch", sorted(ARCH_REGISTRY))
def test_param_spec_of_every_leaf_is_the_references(arch, mode):
    cfg = get_config(arch).reduced()
    ours = build_model(cfg).init(torch.Generator(), device="meta")
    rcfg = REF_ARCHS[arch].reduced()
    model = ref_build_model(rcfg)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    ref_leaves = [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                            for k in path), s)
                  for path, s in jax.tree_util.tree_flatten_with_path(
                      shapes)[0]]
    our_leaves = [("/".join(path), x) for path, x in leaves_with_paths(ours)]
    assert [p for p, _ in our_leaves] == [p for p, _ in ref_leaves]
    rules = AxisRules(mesh=None, mode=mode)
    ref = RefAxisRules(mesh=_ref_mesh(), mode=mode)
    for (path, x), (_, s) in zip(our_leaves, ref_leaves):
        assert tuple(x.shape) == tuple(s.shape), path
        assert rules.param_spec(path, x.ndim) == \
            tuple(ref.param_spec(path, len(s.shape))), path


@pytest.mark.parametrize("model_size", [1, 2, 4])
@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c.name)
@pytest.mark.parametrize("arch", ["gemma3-1b", "gemma2-27b",
                                  "granite-moe-1b-a400m"])
def test_make_rules_sets_the_references_flags(arch, cell, model_size):
    cfg, rcfg = get_config(arch), REF_ARCHS[arch]
    for multi_pod in (False, True):
        want = ref_make_rules(rcfg, AbstractMesh((1, model_size),
                                                 ("data", "model")),
                              cell, multi_pod=multi_pod)
        got = make_rules(cfg, FakeMesh(("data", "model"), (1, model_size)),
                         cell, multi_pod=multi_pod)
        assert _fields(got) == _fields(want)
    assert _fields(make_rules(cfg, None, cell)) == \
        _fields(ref_make_rules(rcfg, None, cell))


@pytest.mark.parametrize("shape", [(8, 6), (11, 5), (3, 7)])
def test_placements_cut_a_tuple_entry_data_major(shape):
    mesh_shape, names = (2, 2, 1), ("pod", "data", "model")
    rules = AxisRules(mesh=FakeMesh(names, mesh_shape), multi_pod=True)
    spec = rules.spec("batch", None)
    assert spec == (("pod", "data"), None)
    placements = rules.placements(spec)
    assert [type(p).__name__ for p in placements] == \
        ["Shard", "Shard", "Replicate"]
    full = np.arange(np.prod(shape)).reshape(shape)
    pieces = []
    for coord in itertools.product(*(range(n) for n in mesh_shape)):
        mine = full[local_slices(shape, mesh_shape, placements, coord)]
        pod, data, _ = coord
        # JAX's data-major order: the block of rank (pod, data) is block
        # pod * n_data + data of the first dim
        if shape[0] % 4 == 0:
            np.testing.assert_array_equal(
                mine, full.reshape(4, shape[0] // 4, -1)[pod * 2 + data])
        # DTensor's cut: torch.chunk on the pod, then on the data axis
        want = torch.chunk(torch.chunk(torch.from_numpy(full), 2)[pod], 2)
        want = want[data].numpy() if data < len(want) else full[:0]
        np.testing.assert_array_equal(mine, want)
        pieces.append(mine)
    np.testing.assert_array_equal(np.concatenate(pieces), full)


def test_placements_refuse_what_a_mesh_cannot_hold():
    rules = AxisRules(mesh=FakeMesh(("data", "model"), (2, 2)))
    with pytest.raises(ValueError, match="not an axis"):
        rules.placements((("pod", "data"),))
    with pytest.raises(ValueError, match="mesh's order"):
        rules.placements((("model", "data"),))
    with pytest.raises(ValueError, match="twice"):
        rules.placements(("data", "data"))
    kv = AxisRules(mesh=FakeMesh(("data", "model"), (2, 2)),
                   long_context=True, kv_shardable=False)
    assert [type(p).__name__ for p in kv.placements(kv.spec("kv_seq"))] \
        == ["Shard", "Shard"]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_the_production_mesh_is_the_references(multi_pod, monkeypatch):
    made = []
    monkeypatch.setattr(ref_mesh.jax, "make_mesh",
                        lambda shape, axes: made.append((tuple(shape),
                                                         tuple(axes))))
    ref_mesh.make_production_mesh(multi_pod=multi_pod)
    assert production_mesh_shape(multi_pod=multi_pod) == made[0]


def test_the_mesh_path_refuses_a_model_axis_and_split_moe():
    dense = get_config("gemma3-1b").reduced()
    moe = get_config("granite-moe-1b-a400m").reduced()

    def rules(cfg, shape, names=("data", "model"), **kw):
        return make_rules(cfg, FakeMesh(names, shape), TRAIN_4K, **kw)
    check_executable(dense, rules(dense, (4, 1)))
    check_executable(moe, rules(moe, (1, 1)))
    check_executable(dense, rules(dense, (1, 2)))   # the sequence on model
    check_executable(moe, rules(moe, (2, 1)))     # global routing
    check_executable(moe, rules(moe, (1, 2)))     # tp: experts on model
    fsdp_sp = rules(dense, (2, 2))
    assert fsdp_sp.batch_shards() == 2 and fsdp_sp.mode == "fsdp_sp"
    assert fsdp_sp.shards("seq") == 2
    fsdp_sp.check(dense)
    moe_sp = dataclasses.replace(moe, shard_mode="fsdp_sp")
    with pytest.raises(NotImplementedError, match=MODEL_AXIS_ITEM):
        rules(moe_sp, (1, 2)).check(moe_sp)
    pod = rules(moe, (2, 3, 1), ("pod", "data", "model"), multi_pod=True)
    assert pod.batch_shards() == 6
    pod.check(moe)
    with pytest.raises(ValueError, match="does not divide"):
        rules(moe, (1, 3)).check(moe)
