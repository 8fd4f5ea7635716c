"""Build the port's native code and load it with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles alone into
``_build/lib<name>-<hash>.so`` (the hash covers the source and every
header it includes by a quoted name from beside it, recursively, so an
edited source or header never loads a stale library). Nothing here runs at import: a kernel
is built at its first launch, or ahead of time by :func:`build_all`, which
starts one nvcc per source at once. The build uses only sources in this
package:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so <name>.cu

(``-Xptxas -v`` keeps each kernel's registers, shared memory and spills in
``_build/lib<name>-<hash>.log``.)

The host packer ``pack/csrc/packlib.cpp`` (name ``packlib``) is C++ for
the CPU and goes through g++ instead, into the same directory:

    g++ -O3 -march=native -fPIC -std=c++17 -Wall -shared \
        -o _build/libpacklib-<hash>.so packlib.cpp -lpthread

Its hash also covers the host's CPU model, since ``-march=native`` builds
for the CPU it runs on. Every build writes a file of its own process and
renames it into place, so processes that build at once (test workers)
never load a half-written library. A missing compiler or a failed build
raises, naming the compiler and the log.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_CSRC = Path(__file__).resolve().parent / "csrc"
_OUT = Path(__file__).resolve().parent / "_build"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# host (CPU) sources by name, built by g++ (native/Makefile's flags)
_HOST = {"packlib": _CSRC.parent.parent / "pack" / "csrc" / "packlib.cpp"}
_GXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
              "-shared"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return path


def gxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found on PATH (the host packer "
                           "pack/csrc/packlib.cpp needs it)")
    return path


def _source(name: str) -> Path:
    return _HOST.get(name) or _CSRC / f"{name}.cu"


def _cpu_model() -> str:
    """The host CPU's model name (``-march=native`` builds for it)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def _sources(name: str) -> list:
    """The source of ``name`` and every header it includes by a quoted name
    found beside the including file, recursively, each once, in the order
    first met."""
    seen, todo = [], [_source(name)]
    while todo:
        f = todo.pop(0)
        if f in seen:
            continue
        seen.append(f)
        for inc in _INCLUDE.findall(f.read_text()):
            header = (f.parent / inc).resolve()
            if header.is_file():
                todo.append(header)
    return seen


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for f in _sources(name):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    if name in _HOST:
        h.update(f"{_GXX_FLAGS} {platform.machine()} {_cpu_model()}"
                 .encode())
    return _OUT / f"lib{name}-{h.hexdigest()[:12]}.so"


def _command(name: str, tmp: Path) -> list:
    src = str(_source(name))
    if name in _HOST:
        return [gxx(), *_GXX_FLAGS, "-o", str(tmp), src, "-lpthread"]
    return [nvcc(), *_FLAGS, "-o", str(tmp), src]


def _start(name: str):
    """Start the compiler for ``name`` unless its library exists. Returns
    (target, (process, temporary library, log) or None)."""
    out = _target(name)
    if out.exists():
        return out, None
    _OUT.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(f".{os.getpid()}.log")
    cmd = _command(name, tmp)
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
    return out, (proc, tmp, log)


def _finish(name: str, out: Path, job) -> None:
    if job is None:
        return
    proc, tmp, log = job
    rc = proc.wait()
    os.replace(log, out.with_suffix(".log"))
    if rc != 0:
        compiler = "g++" if name in _HOST else "nvcc"
        raise RuntimeError(
            f"{compiler} failed for {_source(name).name} (log: "
            f"{out.with_suffix('.log')}):\n"
            f"{out.with_suffix('.log').read_text()}")
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
    """The loaded library for ``csrc/<name>.cu`` (or the host source
    ``name`` of ``_HOST``), built on first use."""
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
