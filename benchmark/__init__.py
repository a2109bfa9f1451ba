"""The benchmark of ssw_tpu_torch (BENCHMARK.json): one cell a run, by
run.py; its plain reference and comparison in reference.py and check.py."""
