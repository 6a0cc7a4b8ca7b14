"""Evaluation: image and depth metrics, disocclusion metrics, the runner."""
