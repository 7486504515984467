"""Logical-axis sharding rules of the mesh path (port of
``repro.sharding``)."""
