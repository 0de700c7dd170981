"""The benchmark of the PyTorch and CUDA port, `insr_pde_tpu_torch`.

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json`; `README.md` says how the
pieces are found by name.
"""
