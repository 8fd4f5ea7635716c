"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles alone into
``_build/lib<name>-<hash>.so`` (the hash is the source's, so an edited
source never loads a stale library). Nothing here runs at import: a kernel
is built at its first launch, or ahead of time by :func:`build_all`, which
starts one nvcc per source at once. The build uses only sources in this
package:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so <name>.cu

(``-Xptxas -v`` keeps each kernel's registers, shared memory and spills in
``_build/lib<name>-<hash>.log``.)
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_CSRC = Path(__file__).resolve().parent / "csrc"
_OUT = Path(__file__).resolve().parent / "_build"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return path


def _target(name: str) -> Path:
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return _OUT / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists. Returns
    (target, process or None)."""
    out = _target(name)
    if out.exists():
        return out, None
    _OUT.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "w")
    try:
        proc = subprocess.Popen(
            [nvcc(), *_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()
    return out, (proc, tmp)


def _finish(name: str, out: Path, job) -> None:
    if job is None:
        return
    proc, tmp = job
    if proc.wait() != 0:
        log = out.with_suffix(".log").read_text()
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source in parallel; returns name -> nvcc log."""
    names = list(names)
    with _lock:
        jobs = {n: _start(n) for n in names}
        for n, (out, job) in jobs.items():
            _finish(n, out, job)
    return {n: out.with_suffix(".log").read_text()
            if out.with_suffix(".log").exists() else ""
            for n, (out, _) in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            out, job = _start(name)
            _finish(name, out, job)
            _libs[name] = ctypes.CDLL(str(out))
    return _libs[name]


@functools.lru_cache(maxsize=None)
def sm_count(device: int) -> int:
    """Streaming multiprocessors of CUDA device ``device`` (the wrappers
    size their grids by it)."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(err: int, what: str) -> None:
    """Raise on a nonzero CUDA error code returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
