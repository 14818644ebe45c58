"""The segment ring (``vpool``), the plan IR and its planner
(``program``), the Eq.-(1)/(2) solvers (``affine``, ``planner``,
``graph_planner``), the tensor-level baselines (``baselines``), the row
schedules (``rowsched``), the clobber oracle (``pool``) and the
executors — counterparts of ``repro.core``."""
