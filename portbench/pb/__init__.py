"""The benchmark harness of repro_torch (see portbench/README.md)."""
