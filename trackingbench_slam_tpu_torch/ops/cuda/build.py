"""Build and load the package's CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc into its own shared library with a plain C
interface, for sm_90a (Hopper), and loaded with ctypes. Builds happen at
first use, never at import: this module only computes paths until a kernel
is asked for. `build_all()` starts one nvcc per source, all together, and
waits for them; the libraries land in trackingbench_slam_tpu_torch/build/,
named by a hash of their source and flags, so an unchanged source is not
rebuilt within a checkout.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("lk", "fast", "patch", "pose")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "trackingbench_slam_tpu_torch need the CUDA toolkit")


def _flags(name: str) -> list[str]:
    # The CUDA runtime is linked into each library (nvcc's default, named):
    # torch.profiler attributes its launches to the custom op and the
    # record_function range around them as it does PyTorch's own, and
    # `-cudart shared` bought nothing (PERF.md). The pose solve rounds
    # every product and sum alone, as its plain version does, so that its
    # poses equal the eager path's bit for bit (chip_smoke.py holds it).
    return ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-cudart", "static",
                         "-Xcompiler", "-fPIC", "-Xptxas", "-v"] + (
                             ["-fmad=false"] if name == "pose" else [])


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()
                            ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every missing library in `names`, one nvcc each, in
    parallel. Returns {name: ptxas report}; raises with nvcc's output if a
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc()] + _flags(name) + ["-o", str(tmp),
                                          str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc {proc.returncode})\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib


def timed_build_all() -> tuple[float, dict[str, str]]:
    t0 = time.perf_counter()
    reports = build_all()
    return time.perf_counter() - t0, reports


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
