"""Data and height parallelism across processes (``torch.distributed``)."""
