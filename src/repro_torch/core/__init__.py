"""Server algorithms (port of ``repro.core``)."""
