"""The frozen input generator and the pool it fills."""
