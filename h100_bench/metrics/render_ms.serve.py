"""Device ms of one ``LSIModel.render`` call (``api.py`` ->
``geometry/ldi.py``): CUDA events around it, the mean over the traced
stretch's batches."""

import statistics


def read(run):
    ms = run.spans.get("render")
    return statistics.fmean(ms) if ms else None
