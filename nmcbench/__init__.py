"""The benchmark of nmcfluid_torch on one NVIDIA H100 (see run.py and
BENCHMARK.json at the repository's root)."""
