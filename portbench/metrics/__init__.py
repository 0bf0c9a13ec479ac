"""Metric readers, one module a metric, named as the metric is in
BENCHMARK.json (a name with a cell's ``metric_suffix`` is read by the
reader of the name without it: ``harness.Catalog.reader``).  Each has ``read(window) -> float | None`` over the run's
``harness.Window``; None leaves the metric out of the result line (a
reader that finds nothing to read, such as a share of a peak from a trace
that lost records, or a card with no published peak).  ``shares`` and
``operator_roofline`` are helpers that several readers share, not
metrics."""
