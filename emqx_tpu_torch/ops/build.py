"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled on
its own by nvcc into ``build/emqx_tpu_torch/lib<name>-<digest>.so``
(``build/`` and ``*.so`` are git-ignored), then loaded with ctypes. The
digest covers the source and the flags, so an edited source is never
served from a stale library. ``build()`` starts one nvcc per missing
library, all at once, and waits for every one of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "emqx_tpu_torch"
SOURCES = ("shape_match", "prefix_sum", "ring_rotate")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES, ptxas_info: bool = False) -> str:
    """Compile every library in `names` that is not built yet, one nvcc
    per source, all started together. Returns the compilers' output
    (with ``ptxas_info`` it holds each kernel's registers and spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    try:
        for name in names:
            src, so = _target(name)
            if so.exists():
                continue
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS,
                   *(("-Xptxas", "-v") if ptxas_info else ()),
                   "-o", str(tmp), str(src)]
            procs.append((name, so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for name, so, tmp, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
            os.replace(tmp, so)
            logs.append(f"[{name}.cu]\n{out}")
        return "\n".join(logs)
    finally:
        for *_, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _, so = _target(name)
            if not so.exists():
                build((name,))
            lib = ctypes.CDLL(str(so))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
