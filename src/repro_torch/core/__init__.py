"""The segment ring (``vpool``), the plan IR and its planner
(``program``), the Eq.-(1)/(2) solvers (``affine``, ``planner``,
``graph_planner``), the tensor-level baselines (``baselines``), the row
schedules (``rowsched``), the clobber oracle (``pool``) and the
executors — counterparts of ``repro.core``.

The executors' registry is exported here (``execute``,
``executor_names``, ``register_executor``), imported at first use: the
kernels import ``core`` submodules, and ``core.executors`` imports the
kernels."""

_EXECUTOR_NAMES = ("execute", "executor_names", "register_executor")
__all__ = list(_EXECUTOR_NAMES)


def __getattr__(name: str):
    if name in _EXECUTOR_NAMES:
        from . import executors
        return getattr(executors, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
