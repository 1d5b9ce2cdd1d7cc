"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

The kernels have a plain C interface, so the build is one ``nvcc`` call per
source (a few seconds) and needs none of PyTorch's headers. A library is built
at first use, from the sources in this package and nothing else, into a build
directory keyed by a hash of the source, the shared headers (``csrc/*.cuh``)
and the flags, so an edit rebuilds and an unchanged source is reused. A failed build raises with the compiler's
output: nothing falls back to another implementation. ``load_libraries``
builds several sources at once, one ``nvcc`` process each.

The build directory is ``build/kernels`` beside the package (``.gitignore``
lists ``build/``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["load_library", "load_libraries", "build_dir", "BUILD_SECONDS",
           "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# Seconds each library took to build in this process (0.0 when reused).
BUILD_SECONDS: dict[str, float] = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "build" / "kernels"


def _find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME, $CUDA_PATH and "
        "/usr/local/cuda): the CUDA kernels of keras_geometric_tpu_torch are "
        "built at first use and need the CUDA toolkit."
    )


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, and load it."""
    source = CSRC / f"{name}.cu"
    text = source.read_bytes() + b"".join(
        header.read_bytes() for header in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = build_dir()
    lib_path = out_dir / f"libkgt_{name}_{digest}.so"
    BUILD_SECONDS[name] = 0.0
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp_path = out_dir / f".{lib_path.name}.{os.getpid()}.tmp"
        cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp_path), str(source)]
        start = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp_path.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed for {source} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp_path, lib_path)  # atomic: concurrent processes agree
        BUILD_SECONDS[name] = time.perf_counter() - start
    return ctypes.CDLL(str(lib_path))


def load_libraries(names) -> list[ctypes.CDLL]:
    """Build (where missing) and load several libraries, their compilers
    running side by side; the first failure raises."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return list(pool.map(load_library, names))
