"""The metric readers, one module a metric, found by the metric's name in
``BENCHMARK.json``: ``read(run) -> float | None``.  A reader that finds
nothing to read returns None, and the run leaves the metric out."""
