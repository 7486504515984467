"""Per-layer metrics, one file each, found by the metric's name."""
