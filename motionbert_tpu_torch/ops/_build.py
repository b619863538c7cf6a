"""Build the CUDA sources under ``ops/csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` compiles, at first use, into a shared library with a
plain C interface under ``build/kernels/`` at the repository root (listed in
``.gitignore``). The file name carries a hash of the sources and flags, so an
edited source builds anew and an unchanged one is reused. Libraries load with
``ctypes``; the wrappers in ``ops/`` set each function's ``argtypes``.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES: Tuple[str, ...] = ("pair_kernels", "pair_bwd_kernels",
                           "pair_q8_kernels", "block_kernels",
                           "st_attention_kernels", "stream_kernels")
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # name -> nvcc's output (ptxas register/smem report)


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the CUDA kernels are built from source at first use")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source that has no current library, one nvcc
    process per source, all started together. Returns name -> library."""
    libs = {name: library_path(name) for name in names}
    todo = {name: so for name, so in libs.items() if not so.exists()}
    if not todo:
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for name, so in todo.items():
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build_all((name,))[name]))
        return _libs[name]
