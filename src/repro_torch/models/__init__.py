"""The paper's MLP classifier (port of ``repro.models``)."""
