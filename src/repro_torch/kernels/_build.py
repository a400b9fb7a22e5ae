"""Builds the port's CUDA sources and loads them with :mod:`ctypes`.

Each source under ``csrc/`` is compiled by ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), at first use, into a build directory (``build/torch_ext/`` at
the repository root unless the caller names another).  A library's file
name carries a hash of its source and flags, so an edited source is
rebuilt and never confused with a stale build.  Nothing is built or
loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import shutil
import subprocess
from pathlib import Path

__all__ = ["BuildResult", "SOURCES", "build_all", "find_nvcc", "library"]

CSRC = Path(__file__).resolve().parent / "csrc"
# csrc/<name>.cu -> lib<name>-<hash>.so
SOURCES = (
    "waterlevel",
    "rd_step",
    "rmsnorm",
    "decode_attention",
    "flash_attention",
    "ssd_scan",
)
DEFAULT_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
NVCC_FLAGS = (
    "-O3",
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    name: str
    path: Path
    built: bool  # False when an up-to-date library was already there
    log: str  # nvcc's output (ptxas register / shared-memory report)


def find_nvcc() -> str:
    """``nvcc`` on the PATH, else under PyTorch's notion of the CUDA home."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from source and "
        "need the CUDA toolkit"
    )


def _target(name: str, build_dir: Path) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir / f"lib{name}-{digest}.so"


def build_all(
    names: tuple[str, ...] = SOURCES, build_dir: Path | None = None
) -> list[BuildResult]:
    """Compile every named source that is not built yet, one ``nvcc``
    process per source, all started together; raises on a failed build."""
    build_dir = Path(build_dir or DEFAULT_BUILD_DIR)
    build_dir.mkdir(parents=True, exist_ok=True)
    pending = []
    results: list[BuildResult] = []
    for name in names:
        target = _target(name, build_dir)
        if target.exists():
            results.append(BuildResult(name, target, False, ""))
            continue
        tmp = target.with_suffix(".tmp.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        pending.append((name, target, tmp, proc))
    for name, target, tmp, proc in pending:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
        tmp.replace(target)  # atomic: a reader never sees half a library
        results.append(BuildResult(name, target, True, log))
    return results


def library(name: str, build_dir: Path | None = None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        (result,) = build_all((name,), build_dir)
        lib = _LOADED[name] = ctypes.CDLL(str(result.path))
    return lib
