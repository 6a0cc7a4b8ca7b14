"""Device ms of one ``LSIModel.predict_ldi`` call (``api.py``): CUDA events
around it, the mean over the traced stretch's batches."""

import statistics


def read(run):
    ms = run.spans.get("predict")
    return statistics.fmean(ms) if ms else None
