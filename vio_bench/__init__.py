"""The benchmark of `pose_estimation_tpu_torch`: `run.py` runs one cell of
the repository's `BENCHMARK.json`; the cells' configurations, traffic
mixes, limits and metric readers are files of their own here, found by
name."""
