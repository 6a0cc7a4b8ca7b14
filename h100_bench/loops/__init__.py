"""The general loops that run a traffic mix, one module per ``loop`` name."""
