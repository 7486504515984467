"""Runtime invariants of the port (port of ``repro.analysis``)."""
