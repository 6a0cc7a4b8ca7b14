"""Device ms of one ``evaluation.trajectory.render_trajectory`` call (the
60-view sweep): CUDA events around it, the mean over the traced
stretch's requests."""

import statistics


def read(run):
    ms = run.spans.get("trajectory")
    return statistics.fmean(ms) if ms else None
