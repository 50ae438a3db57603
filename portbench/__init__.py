"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA card.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: its configuration under
``portbench/configs/``, its traffic mix under ``portbench/traffic/``, the
driver the configuration names under ``portbench/drivers/`` and each per-layer
metric's reader under ``portbench/metrics/``. The yardstick (traffic
generation, operation and byte counts, peaks, the plain reference and the
comparison that decides ``correct``) lives here and imports nothing of the
program it measures.
"""
