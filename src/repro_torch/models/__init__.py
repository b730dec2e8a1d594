"""Model layers and the dense decoder stack."""
