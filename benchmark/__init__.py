"""The benchmark of ``bitar_tpu_torch``: one cell a run, driven by BENCHMARK.json.

Run from the repository root: ``python3 benchmark/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``.
"""
