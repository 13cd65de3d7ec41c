"""Output writers of the port (host numpy, copies of the JAX package's)."""
