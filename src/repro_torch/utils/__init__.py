"""Small utilities (port of ``repro.utils``)."""
