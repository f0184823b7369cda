"""Per-layer metric readers, one file each, found by the metric's name
(``<name>.py``, else the part of the name before its first dot). Each
has ``read(run) -> float | None``: None when it finds nothing to read,
and the metric is then left out of the result."""
