"""Serving: greedy batched generation over ring KV caches
(``engine``)."""
from .engine import Request, ServingEngine, make_serve_fns

__all__ = ["Request", "ServingEngine", "make_serve_fns"]
