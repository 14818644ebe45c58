"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source in ``csrc/`` (``ring_q.cu``, the int8 kernels;
``ring_f32.cu``, the fp32 ones; ``ring_decode.cu``, the decode
attention over a ring KV cache) has a plain C interface: every entry
point takes raw device pointers, ints (and floats) and a CUDA stream,
launches one kernel and returns the launch's ``cudaError_t``, and
``<stem>_error_string`` names an error code.  Each source is compiled
for Hopper (``sm_90a``) into a shared library named by a hash of the
source and the flags, so a changed source rebuilds, under
``<checkout>/build/repro_torch/`` (or the directory
``REPRO_TORCH_BUILD_DIR`` names).  :func:`build_all` starts one nvcc per
source, all at once.  Nothing is built or loaded when this module is
imported: :func:`library` builds on first use.
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

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: C entry points of each source (by stem): argument types, the stream
#: last.
SIGNATURES = {
    "ring_q": {
        "ring_gemm_q": [_P] * 5 + [_I] * 10 + [_P],
        "ring_conv_pw_q": [_P] * 5 + [_I] * 14 + [_P],
        "ring_conv_dw_q": [_P] * 5 + [_I] * 15 + [_P],
        "ring_conv_k2d_q": [_P] * 5 + [_I] * 16 + [_P],
        "ring_avgpool_q": [_P] + [_I] * 9 + [_P],
        "ring_add_q": [_P] + [_I] * 13 + [_P],
        "ring_conv_stream_q": [_P] * 5 + [_I] * 19 + [_P],
        "ring_gru_cell_q": [_P] * 8 + [_I] * 8 + [_P],
    },
    "ring_f32": {
        "ring_gemm": [_P] * 3 + [_I] * 9 + [_P],
        "ring_conv_pw": [_P] * 3 + [_I] * 15 + [_P],
        "ring_conv_dw": [_P] * 3 + [_I] * 15 + [_P],
        "ring_conv_k2d": [_P] * 3 + [_I] * 17 + [_P],
        "ring_add": [_P] + [_I] * 8 + [_P],
        "ring_avgpool": [_P] + [_I] * 9 + [_P],
        "ring_inverted_bottleneck": [_P] * 4 + [_I] * 15 + [_P],
        "ring_conv_stream": [_P] * 3 + [_I] * 20 + [_P],
        "ring_gru_cell": [_P] * 4 + [_I] * 8 + [_P],
        "ring_fused_mlp": [_P] * 5 + [_I] * 13 + [_P],
        "ring_elementwise": [_P] + [_I] * 5 + [_P],
    },
    "ring_decode": {
        "ring_decode_attention": [_P] * 6 + [_I] * 10 + [_F] * 2 + [_I, _P],
    },
}


def source(stem: str) -> Path:
    return CSRC / f"{stem}.cu"


def source_of(entry: str) -> str:
    """The stem of the source that defines C entry point ``entry``."""
    for stem, entries in SIGNATURES.items():
        if entry in entries:
            return stem
    raise KeyError(f"no CUDA source defines {entry!r}")


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


def _library_path(stem: str) -> Path:
    digest = hashlib.sha256(source(stem).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{stem}-{digest[:16]}.so"


def build_all(stems=tuple(SIGNATURES)) -> dict[str, Build]:
    """Compile every source in ``stems`` whose library of the same hash
    is not there yet: one nvcc per source, all started together."""
    started, done = {}, {}
    for stem in stems:
        out = _library_path(stem)
        if out.exists():
            done[stem] = Build(out, False, 0.0, "")
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source(stem))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        started[stem] = (proc, out, tmp, time.perf_counter())
    failed = []
    for stem, (proc, out, tmp, t0) in started.items():
        stdout, stderr = proc.communicate()
        if proc.returncode:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {source(stem)} "
                          f"(exit {proc.returncode}):\n{stderr}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
        done[stem] = Build(out, True, time.perf_counter() - t0,
                           stdout + stderr)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


@functools.cache
def library(stem: str) -> tuple[ctypes.CDLL, Build]:
    """The loaded kernel library of source ``stem`` (built on first
    call) and its build."""
    b = build_all((stem,))[stem]
    lib = ctypes.CDLL(str(b.path))
    for name, argtypes in SIGNATURES[stem].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    err = getattr(lib, f"{stem}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib, b
