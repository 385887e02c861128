"""Data parallelism over N ranks (the JAX package's ``parallel/``):
``mesh`` holds the rank group, the collectives and the gradient sync."""
