"""Metric readers, one file a metric, named as in ``BENCHMARK.json``.

Each defines ``read(run)``: the metric's value from a finished run
(:class:`kbench.harness.cell.Run`), or None where the run has nothing to
read, and the harness then leaves the metric out of the line.
"""
