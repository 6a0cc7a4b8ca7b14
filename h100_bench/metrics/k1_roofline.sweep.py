"""K1's share of its bound: the bound of every K1 call in the traced
stretch (``yardstick.k1_bound_ms`` of the call's shapes, as the loop
states them) over the device time of K1's kernels (box and band) by
name. The traced K1 launches must equal the port's counter and the
loop's shapes, or the reader raises."""

from h100_bench.harness.trace import FAMILIES
from h100_bench.harness.yardstick import k1_bound_ms


def read(run):
    t = run.trace
    counter, fragments = FAMILIES["k1"]
    us, events = t.kernel_us(fragments)
    calls = run.loop.k1_calls() * t.iterations
    if events != len(calls) or t.counters.get(counter) != len(calls):
        raise RuntimeError(f"K1: {events} traced, {t.counters.get(counter)} "
                           f"counted, {len(calls)} calls by the loop")
    if not calls:
        return None
    return 100.0 * sum(k1_bound_ms(*c) for c in calls) / (us / 1e3)
