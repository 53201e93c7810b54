"""Benchmark of marconet_tpu_torch on one H100 (see port_bench/harness.py)."""
