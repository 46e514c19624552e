"""Build and load the package's CUDA kernels.

Each `csrc/<name>.cu` holds one kernel family behind a plain C interface;
the headers `csrc/*.cuh` hold device functions they share.
It is compiled by `nvcc` for Hopper (`sm_90a`) into its own shared library
under the package's `_build/` directory and loaded with `ctypes`; no source
includes PyTorch's headers, so a build takes seconds.  A library's file
name carries a hash of its sources and flags, so an edited source is
rebuilt and an unchanged one is reused.  `build()` starts one `nvcc` per
missing library, all at once, and waits for all of them.

A failure to build or load a library raises `KernelBuildError`, a failed
launch `CudaLaunchError` with its `cudaError_t` code: the device
supervisor (common/device_watchdog.py) reads them by type, so an install
fault is never taken for a device failure.

`-fmad=false` keeps `a*b+c` as a rounded multiply and a rounded add, the
order of operations the plain PyTorch versions use; division and square
root stay IEEE-exact (nvcc's defaults).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
KERNEL_SOURCES = ("threefry", "move_delta", "candidates", "select", "apply", "group", "refresh",
                  "step_globals", "schedule", "scatter", "scenario")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-fmad=false",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: the libraries this process found already built (reused from BUILD_DIR)
#: and the ones it compiled, by name (common/compilation_cache.py reports them)
REUSED: set[str] = set()
BUILT: set[str] = set()


class KernelBuildError(RuntimeError):
    """A kernel library could not be built or loaded: nvcc missing, a
    compile error, a library that does not load.  An install fault, never
    a device failure."""


class CudaLaunchError(RuntimeError):
    """A kernel launch (or a graph call of the kernels' libraries)
    returned a nonzero `cudaError_t`, kept as `code`."""

    def __init__(self, code: int, what: str):
        super().__init__(f"CUDA launch of {what} failed: cudaError_t {code}")
        self.code = int(code)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def library_path(name: str) -> Path:
    h = hashlib.sha1()
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names=KERNEL_SOURCES) -> dict[str, float]:
    """Compile every library in `names` that is not built yet, in parallel.
    Returns {name: seconds} for the ones compiled; raises with nvcc's output
    if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    REUSED.update(n for n in names if n not in todo and n not in BUILT)
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    t0 = time.monotonic()
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp)
    took, failed = {}, []
    for n, (p, tmp) in procs.items():
        log, _ = p.communicate()
        took[n] = time.monotonic() - t0
        if p.returncode != 0:
            failed.append(f"--- {n}.cu (nvcc exit {p.returncode})\n{log.decode(errors='replace')}")
            continue
        tmp.replace(library_path(n))
        BUILT.add(n)
    if failed:
        raise KernelBuildError("CUDA kernel build failed:\n" + "\n".join(failed))
    return took


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel family `name`, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            try:
                lib = ctypes.CDLL(str(library_path(name)))
            except OSError as e:
                raise KernelBuildError(f"kernel library {name} does not load: {e}") from e
            _LIBS[name] = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if status != 0:
        raise CudaLaunchError(status, what)
