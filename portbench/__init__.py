"""portbench: the benchmark of the PyTorch/CUDA viewer (msv_tpu_torch).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line.  Cells,
configurations, traffic mixes and per-layer metrics are files found by
name (``registry.py``).
"""
