"""The device's idle share over the untraced window: the device-busy
seconds an iteration in the device-only traced stretch (the union of its
operations' intervals over its iterations), times the window's
iterations, over the window's host seconds. The tracer's cost on every
launch lengthens the traced stretch's wall and not its operations, so
the share is taken against the window that ran without it."""


def read(run):
    t, w = run.trace, run.window
    busy_s = t.busy_s() / t.iterations * w["iterations"]
    return 100.0 * (1.0 - busy_s / w["seconds"])
