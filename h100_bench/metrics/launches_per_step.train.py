"""Device operations (kernels, copies, fills) per training step over the
traced stretch."""


def read(run):
    t = run.trace
    return len(t.device_ops) / t.iterations
