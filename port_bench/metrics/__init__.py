"""One reader a metric, named as the metric in ``BENCHMARK.json``.

``read(run)`` takes a :class:`port_bench.harness.Run` and returns the
metric's value, or None where the run holds nothing to read it from (the
harness then leaves the metric out of the result).
"""
