"""PyTorch/CUDA port of the VTA stack: the JAX package (``repro``) stays the
reference; this package imports torch and numpy only, never jax or repro."""
