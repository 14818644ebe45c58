"""Sharding rules over DTensors (``sharding``), the gradient collectives
and the model and batch axes' sums over ``torch.distributed``
(``collectives``), and a one-process mesh of threads (``standin``): the
port of ``repro.parallel``."""
from .collectives import (bucketed_psum, bucketed_psum_stacked,
                          compressed_psum, compressed_psum_stacked,
                          dequantize_int8, quantize_int8)
from .sharding import AxisRules, Sharding, no_sharding, place_tree
from .standin import StandInMesh

__all__ = ["AxisRules", "Sharding", "StandInMesh", "bucketed_psum",
           "bucketed_psum_stacked", "compressed_psum",
           "compressed_psum_stacked", "dequantize_int8", "no_sharding",
           "place_tree", "quantize_int8"]
