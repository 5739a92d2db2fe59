"""One reader a metric, found by the metric's name in BENCHMARK.json.

Each module's `read(run)` takes the run's record (`benchmark/run.py`
documents its keys) and returns the metric's value, or None where the run
has nothing to read it from; the harness then leaves the metric out of
the result line. A share of a roofline or of a peak is never 0 for want
of a reading.
"""
