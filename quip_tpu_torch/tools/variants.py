"""Compiled copies of a kernel source, for the tuning tools (tune_decode,
tune_tile, tune_flash, tune_slabdot): a text edit that must apply, every
copy built at once by nvcc with the kernels' own flags, and a module's
attributes (its C entry, its plan rule) swapped for a block."""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

from quip_tpu_torch.kernels import _build


def rep(src: str, old: str, new: str) -> str:
    """``src`` with ``old`` replaced by ``new``; ``old`` must be there."""
    assert old in src, old
    return src.replace(old, new)


_QUOTED = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"[^\n]*\n', re.M)


def source(name: str, headers: bool = False) -> str:
    """The text of ``kernels/csrc/<name>``; with ``headers``, each header it
    includes by a quoted name from ``csrc`` written out in its place (once,
    recursively, ``#pragma once`` dropped), so that an edit can reach the
    device code a kernel shares with another."""
    text = (_build._CSRC / name).read_text()
    if not headers:
        return text
    seen = set()

    def expand(mt):
        path = _build._CSRC / mt.group(1)
        if not path.is_file():
            return mt.group(0)
        if path.name in seen:
            return ""
        seen.add(path.name)
        body = path.read_text().replace("#pragma once\n", "")
        return _QUOTED.sub(expand, body)
    return _QUOTED.sub(expand, text)


def serialised(log: str) -> int:
    """ptxas's notes in a ``-Xptxas -v`` log that it serialised a kernel's
    wgmma (C7513, C7515, ...: "wgmma.mma_async instructions are
    serialized")."""
    return log.count("wgmma.mma_async instructions are serialized")


def _cached_path(text: str) -> Path:
    """Where ``build(..., cached=True)`` keeps the library of ``text``: a
    hash of it, of the kernels' headers and of nvcc's flags."""
    h = hashlib.sha256(text.encode() + " ".join(_build._FLAGS).encode())
    for f in sorted(_build._CSRC.glob("*.cuh")):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return _build._OUT / f"libvariant-{h.hexdigest()[:12]}.so"


def build(texts: dict, entry: str, argtypes, ptxas: bool = False,
          cached: bool = False) -> dict:
    """Compile each source text at once (csrc on the include path, so the
    copies find its headers); name -> the C function ``entry`` of each,
    with ``argtypes`` and an int result (its library as ``.lib``). With
    ``ptxas``, prints each copy's registers, spills and serialised wgmma
    (ptxas's "serialized" notes: C7513, C7515). With ``cached``, each
    library is kept in ``kernels/_build`` (``_cached_path``) and a later
    build of the same text loads it without compiling."""
    fns = {}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for i, (name, text) in enumerate(texts.items()):
            keep = _cached_path(text) if cached else None
            if keep is not None and keep.exists():
                jobs[name] = (keep, None)
                continue
            cu, so = Path(tmp) / f"v{i}.cu", Path(tmp) / f"v{i}.so"
            cu.write_text(text)
            jobs[name] = (so, subprocess.Popen(
                [_build.nvcc(), *_build._FLAGS, "-I", str(_build._CSRC),
                 "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, (so, proc) in jobs.items():
            if proc is not None:
                log = proc.communicate()[0]
                assert proc.returncode == 0, (name, log[-2000:])
                if ptxas:
                    regs = re.findall(r"Used (\d+) registers", log)
                    spill = re.findall(r"(\d+) bytes spill stores", log)
                    print(f"  ptxas {name}: {regs} registers, {spill} "
                          f"bytes spilled, wgmma serialised "
                          f"x{serialised(log)}", flush=True)
                if cached:
                    keep = _cached_path(texts[name])
                    keep.parent.mkdir(parents=True, exist_ok=True)
                    part = keep.with_suffix(f".{os.getpid()}.tmp")
                    shutil.copyfile(so, part)
                    os.replace(part, keep)
                    so = keep
            lib = ctypes.CDLL(str(so))
            f = getattr(lib, entry)
            f.argtypes, f.restype = argtypes, ctypes.c_int
            f.lib = lib                 # the copy's other entries
            fns[name] = f
    return fns


@contextlib.contextmanager
def swapped(module, **attrs):
    """``module``'s attributes set to ``attrs`` for the block's duration."""
    old = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
