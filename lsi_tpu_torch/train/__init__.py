"""The training step: loss, gradients and the optimizer update."""
