"""raybench: the benchmark of bvh_tpu_torch, the PyTorch and CUDA port.

`python3 raybench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` on one card and prints
one JSON line. See `raybench/README.md`.
"""
