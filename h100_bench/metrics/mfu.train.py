"""The whole training step's share of the card's bf16 peak: the network's
convolution operations (the configuration file's count, a function of
its shapes) over the window's host seconds, against 989 TFLOP/s (H100
SXM, dense, 700 W; the result line carries the card's power limit)."""

from h100_bench.harness.yardstick import BF16_FLOP_PER_S


def read(run):
    w = run.window
    return 100.0 * run.loop.flops(w["units"]) / w["seconds"] / BF16_FLOP_PER_S
