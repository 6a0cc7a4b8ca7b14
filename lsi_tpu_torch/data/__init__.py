"""Input data: the synthetic scenes and the batch stream."""
