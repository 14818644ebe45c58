"""The segment ring (``vpool``), the plan IR (``program``), the row maps
(``rowsched``) and the executors — counterparts of ``repro.core``."""
