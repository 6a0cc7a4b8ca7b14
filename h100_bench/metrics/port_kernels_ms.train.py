"""Device ms per step in the kernels built from ``lsi_tpu_torch/csrc/``
(K1, K1-D, K2, K4 and their windowed modes), by name."""

from h100_bench.harness.trace import PORT_KERNELS


def read(run):
    t = run.trace
    us, events = t.kernel_us(PORT_KERNELS)
    return us / 1e3 / t.iterations if events else None
