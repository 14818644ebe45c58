"""Int8 quantization: parameters, calibration and fixed-point
requantization — counterparts of ``repro.quant``."""
