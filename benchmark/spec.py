"""Everything a cell needs, found by name.

``BENCHMARK.json`` (the checkout's root) names each cell's configuration
and traffic mix. The configuration is ``configs/<config>.json``, the mix
``traffic/<traffic>.json``, the limits of the numbers that decide
``correct`` ``limits/<cell>.json``, and each per-layer metric's reader
``metrics/<metric>.py`` (or its quantity's, see ``reader``). A metric's
layer, unit, source, what it moves and its cells are its entry in
``BENCHMARK.json`` alone. A new cell, configuration, mix or metric is new
files and new entries; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def config(name: str) -> dict:
    return _json("configs", name)


def mix(name: str) -> dict:
    return _json("traffic", name)


def limits(cell: str) -> dict:
    return _json("limits", cell)


def reader(metric: str) -> ModuleType:
    """The module of ``metrics/<metric>.py``, or where there is none, of
    the quantity's ``metrics/<name up to the first dot>.py`` (a quantity
    split by the end-to-end metric it moves, ``idle_share.chat`` and
    ``idle_share.ppl``, has one reader). Names hold dots, so it is loaded
    from its path."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{metric.split('.', 1)[0]}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for {metric!r} under "
                                f"{(HERE / 'metrics').relative_to(ROOT)}")
    name = "benchmark.metrics._" + metric.replace(".", "_").replace("-", "_")
    s = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict = None) -> Dict:
    """The cell ``name``: its entry, configuration, mix, limits, and the
    end-to-end and per-layer metrics it reports."""
    bench = bench or benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    moved = {m["name"] for m in e2e}
    per: List[dict] = [m for m in bench["per_layer"]
                       if (name in m["workloads"] if "workloads" in m
                           else m["moves"] in moved)]
    return dict(workload=w, config=config(w["config"]),
                mix=mix(w["traffic"]), limits=limits(name), end_to_end=e2e,
                per_layer=per)
