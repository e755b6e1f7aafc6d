"""The benchmark of the PyTorch and CUDA port (`repro_torch`).

`python3 -m rdfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once and prints one
JSON line.  Configurations, traffic mixes and metric readers are files
found by name under this folder (`configs/`, `traffic/`, `metrics/`).
"""
