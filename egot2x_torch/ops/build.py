"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles, for ``sm_90a`` (Hopper), into a shared
library with a plain C interface under ``build/egot2x_torch/`` at the
repository root; ``jpeg.cu`` links the CUDA toolkit's nvJPEG
(``LIBRARIES``). The file name carries a hash of the source, so an edited
kernel is rebuilt and a built one is reused by every later process.
Nothing is built at import: the first launch of a kernel builds it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "egot2x_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# libraries of the toolkit a source links, found beside nvcc at run time too
LIBRARIES = {"jpeg": ("nvjpeg",)}


@dataclass(frozen=True)
class Built:
    """One compiled source: its library, and how the build went."""

    name: str
    path: Path
    seconds: float   # 0.0 when an earlier process built it
    log: str         # nvcc's output, the ``-Xptxas -v`` report included


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _link_flags(name: str, nvcc: str) -> list:
    libs = LIBRARIES.get(name, ())
    if not libs:
        return []
    lib_dir = str(Path(nvcc).resolve().parent.parent / "lib64")
    return [f"-L{lib_dir}", "-Xlinker", f"-rpath={lib_dir}",
            *(f"-l{lib}" for lib in libs)]


def _target(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` unless its current library exists."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = _target(name)
    log_path = target.with_suffix(".log")
    if target.exists():
        return Built(name, target, 0.0,
                     log_path.read_text() if log_path.exists() else "")
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"),
           *_link_flags(name, nvcc)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    log_path.write_text(proc.stdout)
    os.replace(tmp, target)  # atomic: concurrent builds agree
    return Built(name, target, seconds, proc.stdout)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    return ctypes.CDLL(str(build(name).path))
