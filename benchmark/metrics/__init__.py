"""One reader per per-layer metric, named as the metric: ``read(rec)``
takes the traced run's record (the driver's: its ``trace``, counters and
the cell's shapes) and returns the number, or None where it finds
nothing to read."""
