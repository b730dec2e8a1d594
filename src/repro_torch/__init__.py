"""PyTorch port of the serving stack (the JAX package ``repro`` is the reference)."""
