"""Sharding rules over DTensors (``sharding``) and the gradient
collectives over ``torch.distributed`` (``collectives``): the port of
``repro.parallel``."""
from .collectives import (bucketed_psum, bucketed_psum_stacked,
                          compressed_psum, compressed_psum_stacked,
                          dequantize_int8, quantize_int8)
from .sharding import AxisRules, Sharding, no_sharding, place_tree

__all__ = ["AxisRules", "Sharding", "bucketed_psum", "bucketed_psum_stacked",
           "compressed_psum", "compressed_psum_stacked", "dequantize_int8",
           "no_sharding", "place_tree", "quantize_int8"]
