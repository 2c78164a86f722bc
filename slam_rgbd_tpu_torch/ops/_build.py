"""Build the CUDA sources in `csrc/` with nvcc and load them with ctypes.

`load()` compiles every `csrc/*.cu` (one nvcc a source, all started
together) and links them into one shared library with a plain C interface,
under `build/kernels/` at the root of the checkout, named by a hash of the
sources and flags: a changed source builds anew, an unchanged one loads the
library already built. Nothing is built on import; the first kernel launch
calls `load()`. Only sources in this package are compiled.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# --fmad=false: no contraction of a*b+c into one rounding, so the kernels
# round every product and sum as the plain torch versions do.
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *_ARCH, "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "--fmad=false",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "gn_reduce_scratch_floats": ([_I, _I], _I),
    "gn_reduce_launch": ([_P, _P, _P] + [_I] * 3 + [_F] * 10 + [_P] * 4, _I),
    "gn_reduce_batched_scratch_floats": ([_I, _I, _I], _I),
    "gn_reduce_batched_launch": (
        [_P, _P, _P] + [_I] * 4 + [_F] * 10 + [_P] * 4, _I),
    "gn_reduce_error_string": ([_I], ctypes.c_char_p),
    "hamming_top2_launch": ([_P, _P, _I, _P, _P, _I] + [_P] * 6, _I),
    "gated_match_launch": (
        [_P, _P, _I, _P, _P, _I] + [_F] * 3 + [_P] * 7, _I),
}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"slam_kernels_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    lib_path = library_path()
    if not lib_path.exists():
        build(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def build(lib_path: Path) -> float:
    """Compile the sources into `lib_path`; returns the seconds it took.

    Each source is compiled to an object by an nvcc of its own, all running
    at once, and one more nvcc links them. The compiler's report (registers,
    spills) is kept beside the library as `<name>.log`.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{lib_path.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    tmp = BUILD_DIR / f"{tag}.tmp"
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(_sources(), objects)
    ]
    report = "".join(proc.communicate()[0] for proc in procs)
    failed = [proc.returncode for proc in procs if proc.returncode != 0]
    if not failed:
        link = subprocess.run(
            [nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objects)],
            capture_output=True, text=True,
        )
        report += link.stdout + link.stderr
        failed = [link.returncode] if link.returncode != 0 else []
    seconds = time.perf_counter() - t0
    for obj in objects:
        obj.unlink(missing_ok=True)
    lib_path.with_suffix(".log").write_text(report)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{report}")
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or none
    return seconds


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = load().gn_reduce_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
