"""Per-layer metric readers: ``<name>.py`` holds ``read(run)`` of metric
``<name>``; it returns None where the run has nothing to read."""
