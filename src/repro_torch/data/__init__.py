"""Synthetic federated data (port of ``repro.data``)."""
