"""BENCHMARK.json against the contract it is written to, and every piece
of every cell found by name."""
import json
import re

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
B = spec.benchmark()


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["benchmark"]
    assert 1 <= B["run_seconds"] <= 51
    assert all(isinstance(w, str) and "\n" not in w for w in B["command"])
    assert len(json.dumps(B)) < 64 * 1024


def test_names_units_and_keys():
    names = set()
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert (spec.ROOT / c["file"]).is_file()
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("w", [w["name"] for w in B["workloads"]])
def test_cell_found_by_name(w):
    cell = spec.cell(w)
    assert cell["mix"]["driver"] in ("serve", "ppl")
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["per_layer"]
    for m in cell["per_layer"]:
        assert m["moves"] in e2e
    assert cell["limits"]


@pytest.mark.parametrize("m", [m["name"] for m in B["per_layer"]])
def test_reader_found_for_each_metric(m):
    entry = [x for x in B["per_layer"] if x["name"] == m][0]
    mod = spec.reader(m)
    assert callable(mod.read) and mod.__doc__
    assert set(entry) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    assert entry["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_reader_of_the_quantity(tmp_path, monkeypatch):
    """A metric split by what it moves falls back to its quantity's
    reader; a file of the metric's own name comes first."""
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "q.py").write_text(
        '"""q"""\ndef read(run):\n    return 1.0\n')
    (tmp_path / "metrics" / "q.own.py").write_text(
        '"""q.own"""\ndef read(run):\n    return 2.0\n')
    monkeypatch.setattr(spec, "HERE", tmp_path)
    monkeypatch.setattr(spec, "ROOT", tmp_path.parent)
    assert spec.reader("q.chat").read(None) == 1.0
    assert spec.reader("q.own").read(None) == 2.0


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric")
