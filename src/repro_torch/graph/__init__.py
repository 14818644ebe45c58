"""The whole-network compiler and its execution on the ring —
counterpart of ``repro.graph``: the IR and its builders (``ir``),
operator reordering and fusion groups (``schedule``), the one-ring
planner (``netplan``) and run/certify/calibrate (``run``)."""
