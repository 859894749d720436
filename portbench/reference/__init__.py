"""Plain PyTorch references: they import nothing of the program or of JAX."""
