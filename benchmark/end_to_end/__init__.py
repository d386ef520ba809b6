"""End-to-end metric readers: ``<name>.py`` holds ``read(run)`` of metric
``<name>``, on the host clock."""
