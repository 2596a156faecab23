"""Per-layer metric readers, one file a metric (or a family of metrics
that share the part of their name before the first dot). Each defines
``read(readings) -> float | None``: ``None`` when the run gave it
nothing to read, and the harness then leaves the metric out."""
