"""What runs on the card loads nothing of jax or the JAX package, compared
by whole top-level module names; without a card, or outside a checkout
that holds the program, a run prints no result."""
import os
import shutil
import subprocess
import sys
import types

from benchmark import run as R
from benchmark import spec


def test_barred_names_are_whole_top_level_names(monkeypatch):
    for name in ("quip_tpu", "quip_tpu.models", "jax.numpy", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
        assert name in R.barred_modules()
        monkeypatch.delitem(sys.modules, name)
    for name in ("quip_tpu_torch", "quip_tpu_torch.serve", "jaxtyping",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
        assert name not in R.barred_modules()
        monkeypatch.delitem(sys.modules, name)


def test_harness_and_program_load_no_barred_module():
    code = ("import benchmark.run, benchmark.serve, benchmark.ppl, "
            "benchmark.calibrate, benchmark.sweep, benchmark.readers; "
            "import quip_tpu_torch.serve.engine, quip_tpu_torch.eval.ppl, "
            "quip_tpu_torch.kernels._build; "
            "[benchmark.spec.reader(m['name']) for m in "
            "benchmark.spec.benchmark()['per_layer']]; "
            "print(benchmark.run.barred_modules())")
    got = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr
    assert got.stdout.strip() == "[]"


def _run(cwd):
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "opt-6.7b.chat-b8", "--seed", "1", "--seconds", "1"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_card_no_result():
    got = _run(spec.ROOT)
    assert got.returncode != 0 and got.stdout.strip() == ""


def test_bare_directory_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = _run(tmp_path)
    assert got.returncode != 0 and got.stdout.strip() == ""
