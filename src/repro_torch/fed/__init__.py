"""Federated-algorithm API: clock, population, registry and simulation
harness (port of ``repro.fed``)."""
