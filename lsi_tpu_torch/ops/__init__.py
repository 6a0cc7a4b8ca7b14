"""Plain PyTorch versions of the kernels' operations."""
