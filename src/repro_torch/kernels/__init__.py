"""The port's hand-written CUDA ring kernels (``csrc/``), their build
(``_build``), their Python wrappers and plain versions (``quantized``) and
the parity cases they are held to (``cases``)."""
