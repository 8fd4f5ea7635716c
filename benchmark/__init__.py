"""The benchmark of the PyTorch and CUDA port (``quip_tpu_torch``).

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. Everything a cell
needs is found by name: its configuration in ``configs/``, its traffic mix
in ``traffic/``, its limits in ``limits/`` and each per-layer metric's
reader in ``metrics/``. ``reference/`` is the plain PyTorch model that
decides ``correct``; it imports nothing of the port. See README.md.
"""
