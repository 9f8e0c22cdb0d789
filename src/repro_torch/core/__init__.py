"""Tiling and TPS search (copied from the JAX package, JAX-free)."""
