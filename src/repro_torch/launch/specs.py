"""The sharding rules of one (arch x shape x mesh) cell (the port of
``repro.launch.specs``'s ``make_rules``).

The rest of the reference's module (``state_specs``, ``params_specs``,
``batch_specs``, ``cache_specs``, ``input_specs``: the stand-ins that its
dry-run lowers) is not ported yet; it waits with ``launch/dryrun.py``
for ROADMAP Queue 1 item 9.7.
"""
from __future__ import annotations

from ..parallel.sharding import AxisRules, axis_sizes


def make_rules(cfg, mesh, cell, multi_pod: bool = False) -> AxisRules:
    """The rules of ``cfg`` under ``cell`` (a ``ShapeCell``) on ``mesh``
    (a ``DeviceMesh`` or None): the config's shard mode, decode flags
    from the cell's kind, long context for a batch-1 decode, and KV
    heads shardable where the ``model`` axis divides them."""
    model_size = axis_sizes(mesh).get("model", 1) if mesh is not None else 1
    return AxisRules(
        mesh=mesh,
        mode=cfg.shard_mode,
        multi_pod=multi_pod,
        decode=(cell.kind == "decode"),
        long_context=(cell.kind == "decode" and cell.global_batch == 1),
        kv_shardable=(model_size > 0
                      and cfg.n_kv_heads % max(model_size, 1) == 0),
    )
