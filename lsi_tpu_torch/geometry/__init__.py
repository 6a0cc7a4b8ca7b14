"""Camera geometry and the LDI render."""
