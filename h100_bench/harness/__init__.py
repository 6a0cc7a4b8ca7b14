"""The harness: one run of one cell (``run.py`` is its command line)."""
