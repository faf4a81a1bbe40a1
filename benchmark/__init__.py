"""The benchmark of the PyTorch/CUDA port (``mpi_blockchain_tpu_torch``).

``BENCHMARK.json`` at the root names its cells; ``python -m benchmark
--workload <name> --seed <n> --seconds <s> --trace <0|1>`` runs one cell
once and prints one JSON line. Configurations, traffic mixes, drivers and
metric readers sit in files of their own under ``configs/``,
``workloads/``, ``drivers/`` and ``metrics/``, found by name
(``spec.py``). The plain reference that decides ``correct`` is
``reference.py``; the control that it has to fail is ``control.py``.
"""
