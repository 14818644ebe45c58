"""Build the port's CUDA kernels with nvcc and load them with ctypes.

``csrc/ring_q.cu`` has a plain C interface: every entry point takes raw
device pointers, ints and a CUDA stream, launches one kernel and returns
the launch's ``cudaError_t``.  It is compiled for Hopper (``sm_90a``)
into a shared library named by a hash of the source and the flags, so a
changed source rebuilds, under ``<checkout>/build/repro_torch/`` (or the
directory ``REPRO_TORCH_BUILD_DIR`` names).  Nothing is built or loaded
when this module is imported: :func:`library` builds on first use.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "ring_q.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int

#: C entry points of ring_q.cu: argument types, the stream last.
SIGNATURES = {
    "ring_gemm_q": [_P] * 5 + [_I] * 9 + [_P],
    "ring_conv_pw_q": [_P] * 5 + [_I] * 14 + [_P],
    "ring_conv_dw_q": [_P] * 5 + [_I] * 14 + [_P],
    "ring_conv_k2d_q": [_P] * 5 + [_I] * 15 + [_P],
    "ring_avgpool_q": [_P] + [_I] * 9 + [_P],
    "ring_add_q": [_P] + [_I] * 12 + [_P],
    "ring_conv_stream_q": [_P] * 5 + [_I] * 17 + [_P],
    "ring_gru_cell_q": [_P] * 8 + [_I] * 6 + [_P],
}


@dataclasses.dataclass(frozen=True)
class Build:
    """Where the library is, and what building it took (``compiled`` is
    False when a library of the same source hash was already there)."""

    path: Path
    compiled: bool
    seconds: float
    log: str

    @property
    def ptxas_lines(self) -> list[str]:
        """The ``-Xptxas -v`` lines on registers, shared memory and
        spills of each kernel."""
        return [ln.strip() for ln in self.log.splitlines()
                if "ptxas info" in ln and ("Used" in ln or "spill" in ln
                                           or "Compiling" in ln)]


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def build(source: Path = SOURCE) -> Build:
    """Compile ``source`` unless a library of its hash exists."""
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = build_dir() / f"lib{source.stem}-{digest[:16]}.so"
    if out.exists():
        return Build(out, False, 0.0, "")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(source)], capture_output=True, text=True)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)      # atomic: a concurrent loader sees all or none
    return Build(out, True, time.perf_counter() - t0,
                 proc.stdout + proc.stderr)


@functools.cache
def library() -> tuple[ctypes.CDLL, Build]:
    """The loaded kernel library (built on first call) and its build."""
    b = build()
    lib = ctypes.CDLL(str(b.path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ring_q_error_string.argtypes = [ctypes.c_int]
    lib.ring_q_error_string.restype = ctypes.c_char_p
    return lib, b
