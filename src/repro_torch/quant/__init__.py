"""Int8 quantization: parameters and fixed-point requantization —
counterparts of ``repro.quant``."""
