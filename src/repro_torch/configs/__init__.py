"""Configurations (port of ``repro.configs``)."""
