"""Compression: rotation geometry, the exchange pipeline and the lattice
codecs (port of ``repro.compression``)."""
