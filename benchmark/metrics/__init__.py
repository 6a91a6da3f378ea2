"""One reader per metric, found by the metric's name: ``read(run)``
returns the value from a :class:`benchmark.records.Run`, or None where
the run holds nothing to read."""
