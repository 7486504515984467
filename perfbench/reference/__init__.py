"""The plain reference: imports neither the program nor JAX."""
