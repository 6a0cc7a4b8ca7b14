"""Device operations per step launched inside the port's profiler range
``train_step/optimizer`` (``train/trainer.py``): each operation's
runtime launch call placed within the range on the host, in the stretch
that records the host's ranges."""


def read(run):
    t = run.host_trace
    if not t.host_ranges("train_step/optimizer"):
        return None
    return t.ops_launched_in("train_step/optimizer") / t.iterations
