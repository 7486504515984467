"""Traffic: the one generator and its frozen helpers."""
