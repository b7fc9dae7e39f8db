"""Build the port's CUDA kernels from ``csrc/`` and bind them with ctypes.

``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
-fPIC -c`` compiles every ``csrc/*.cu`` to an object, one nvcc process per
source, all started together; one more nvcc links the objects into a shared
library with a plain C interface.  The library lands in ``_build/`` next to
this file, named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads at once.  Nothing is built at import:
the first kernel launch builds, and a failed build raises with nvcc's
output.  ``nvcc`` is taken from ``PATH``, else from ``$CUDA_HOME/bin``
(default ``/usr/local/cuda``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# A build takes seconds; a hung compiler must not hang the caller.
NVCC_TIMEOUT_S = 600

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_U = ctypes.c_uint
# C entry points: argument types (all return an int cudaError_t).
SIGNATURES = {
    "gsmvi_factor_apply": [_P] * 5 + [_I] * 5 + [_P],
    "gsmvi_factor_apply_oracle": [_P] * 5 + [_I] * 3 + [_P],
    "gsmvi_thin_rows": [_P] * 6 + [_I] * 4 + [_L, _I, _I, _P],
    "gsmvi_thin_score": [_P] * 4 + [_I] * 4 + [_P],
    "gsmvi_thin_rows_mma": [_P] * 5 + [_I] * 4 + [_L, _I, _I, _I, _P],
    "gsmvi_factor_apply_mma": [_P] * 5 + [_I] * 6 + [_P],
    "gsmvi_eps_smallspace_cluster": [_P] * 13 + [_I] * 7
    + [_F, _I, _L, _I, _I, _P],
    "gsmvi_eps_chol": [_P] * 12 + [_I] * 4 + [_F, _P],
    "gsmvi_philox": [_P, _P, _L, _L, _U, _U, _P],
    "gsmvi_gsm_update": [_P] * 8 + [_I] * 7 + [_P],
    "gsmvi_bam_apply": [_P] * 6 + [_I] * 5 + [_P],
    "gsmvi_bam_apply_oracle": [_P] * 6 + [_I] * 3 + [_P],
    "gsmvi_bam_smallspace_cluster": [_P] * 12 + [_I, _I, _F] + [_I] * 5
    + [_F, _F, _F] + [_I] * 3 + [_P, _I, _P],
    "gsmvi_bam_finalize": [_P, _I] + [_P] * 6 + [_I, _I, _F, _I, _I, _P],
    "gsmvi_bam_select": [_P] * 4 + [_I, _I, _P],
    "gsmvi_advi_rows": [_P] * 6 + [_I] * 3 + [_P],
    "gsmvi_advi_update": [_P] * 3 + [_I] * 2 + [_P] * 6 + [_I] * 2
    + [_F] * 6 + [_P],
    "gsmvi_advi_residual": [_P] * 6 + [_I, _F, _P],
    "gsmvi_advi_sweep": [_P] * 4 + [_I, _P],
    "gsmvi_advi_stl_grad": [_P] * 6 + [_I, _I, _P],
    "gsmvi_advi_stl_apply": [_P] * 13 + [_I] * 3 + [_F] * 5 + [_P],
    "gsmvi_eps_smallspace_large": [_P] * 16 + [_I] * 3 + [_F, _I, _L, _I, _I, _P],
    "gsmvi_eps_smallspace_panel": [_P] * 14 + [_I] * 7 + [_F, _I, _L, _P],
    "gsmvi_bam_smallspace_panel": [_P] * 13 + [_I, _I, _F] + [_I] * 5
    + [_F, _F, _F, _P, _I, _P],
    "gsmvi_funnel_score": [_P] * 3 + [_I] * 4 + [_P],
    "gsmvi_banana_score": [_P] * 3 + [_I] * 4 + [_P],
    "gsmvi_student_t_score": [_P] * 7 + [_I] * 4 + [_P],
    "gsmvi_mixture_score": [_P] * 4 + [_I] * 5 + [_P],
    "gsmvi_logreg_score": [_P] * 6 + [_I] * 5 + [_P],
}
# C entry points returning a size (long long): argument types.
SIZES = {
    "gsmvi_eps_large_ws": [_I],
    "gsmvi_eps_large_sync": [_I],
    "gsmvi_eps_grid_blocks": [_I],
    "gsmvi_eps_panel_ws": [_I],
    "gsmvi_bam_panel_ws": [_I],
    "gsmvi_eps_panel_clusters": [_I],
    "gsmvi_bam_panel_clusters": [_I],
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or in $CUDA_HOME/bin: the "
                       "CUDA kernels are built from source with the CUDA "
                       "toolkit")


def _sources() -> list:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libgsmvi_kernels_{h.hexdigest()[:16]}.so"


def _nvcc_all(cmds, logs) -> str:
    """Run the nvcc commands concurrently, each writing to its log file;
    return their joint output, or raise with the output of the first that
    failed.  Every process has ended when this returns or raises."""
    procs = []
    for cmd, log in zip(cmds, logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(cmd, stdout=f,
                                          stderr=subprocess.STDOUT))
    deadline = time.monotonic() + NVCC_TIMEOUT_S
    for proc in procs:
        try:
            proc.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    outs = [Path(log).read_text() for log in logs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}): "
                               f"{' '.join(cmd)}\n{out[-6000:]}")
    return "".join(outs)


def build() -> tuple:
    """(path of the built library, seconds spent in nvcc; 0 if cached).
    nvcc's output (with ``-Xptxas -v``: registers, shared memory, spills of
    every kernel) is kept beside the library as ``.log``."""
    so = library_path()
    if so.exists():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = BUILD_DIR / f"{so.stem}.{os.getpid()}"
    tmp = Path(f"{tag}.tmp.so")
    srcs = [p for p in _sources() if p.suffix == ".cu"]
    objs = [Path(f"{tag}.{p.stem}.o") for p in srcs]
    logs = [Path(f"{tag}.{p.stem}.out") for p in [*srcs, Path("link")]]
    t0 = time.perf_counter()
    try:
        out = _nvcc_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
                         for p, o in zip(srcs, objs)], logs[:-1])
        out += _nvcc_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                           *map(str, objs)]], logs[-1:])
        seconds = time.perf_counter() - t0
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)
    finally:
        for path in (tmp, *objs, *logs):
            path.unlink(missing_ok=True)
    return so, seconds


class KernelLibrary:
    """The loaded shared library; ``call`` raises on a CUDA error code."""

    def __init__(self, path: Path, build_seconds: float):
        self.path = path
        self.build_seconds = build_seconds
        self._lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name, argtypes in SIZES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_longlong
        self._lib.gsmvi_error_string.argtypes = [ctypes.c_int]
        self._lib.gsmvi_error_string.restype = ctypes.c_char_p

    def size(self, name: str, *args) -> int:
        """The value of a size entry point (``SIZES``)."""
        return int(getattr(self._lib, name)(*args))

    def call(self, name: str, *args) -> None:
        rc = getattr(self._lib, name)(*args)
        if rc != 0:
            msg = self._lib.gsmvi_error_string(rc).decode()
            raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


_LIBRARY = None


def load_library() -> KernelLibrary:
    """Build (first use only) and load the kernel library."""
    global _LIBRARY
    if _LIBRARY is None:
        _LIBRARY = KernelLibrary(*build())
    return _LIBRARY
