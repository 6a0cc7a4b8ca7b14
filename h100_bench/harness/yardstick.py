"""The benchmark's frozen arithmetic: the card's peaks, the network's
operations per image and K1's bound, all functions of shapes.

The peaks are NVIDIA's data sheet for the H100 SXM at 700 W (dense, no
sparsity); a card set below 700 W (``power.limit``) reaches less, and
every result prints the limit beside its numbers. ``bound_ms`` and
``k1_bound_ms`` are ``chip_smoke.bound`` and ``chip_smoke.k1_bound`` at
commit ee70f4d (each tensor read or written once at the HBM rate,
against float32 operations at the float32 peak), with the operations
counted for every corner: for K1 the bytes bound by more than ten times,
so the count does not reach the bound.
"""

from __future__ import annotations

from typing import Dict

BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound_ms(nbytes: float, flops: float) -> float:
    """The larger of bytes over the HBM rate and float32 operations over
    the float32 peak, in ms."""
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)


def k1_bound_ms(n: int, src_h: int, src_w: int, channels: int, out_h: int,
                out_w: int, weights: bool = True) -> float:
    """K1 on values (n, src_h, src_w, C): values, coords (and weights)
    read once, accum (and wsum) written once, 2 (C + 1) operations a
    corner."""
    planes = channels + int(weights)
    px = n * src_h * src_w
    nbytes = 4 * px * (channels + 2 + int(weights)) \
        + 4 * n * out_h * out_w * planes
    return bound_ms(nbytes, 2 * planes * 4 * px)


def conv_flops(cin: int, cout: int, k: int, out_h: int, out_w: int) -> int:
    """A k x k convolution's operations, a multiply-add counted as 2."""
    return 2 * cin * cout * k * k * out_h * out_w


def network_flops(model: Dict, height: int, width: int) -> Dict[str, int]:
    """The LDI network's convolution operations for one image:
    ``forward``, and ``train`` = forward + backward (each convolution's
    input gradient, except the first layer's, whose input is the image,
    and its weight gradient), as ``torch.utils.flop_counter`` counts
    them."""
    f, ns, l = model["base_filters"], model["num_scales"], model["num_layers"]
    filts = [min(f * 2 ** i, f * 8) for i in range(ns)]
    convs = []  # (cin, cout, k, out_h, out_w, input_needs_grad)
    h, w, cin = height, width, 3
    for i, c in enumerate(filts):
        convs.append((cin, c, 3, h, w, i > 0))
        convs.append((c, c, 3, h // 2, w // 2, True))
        h, w, cin = h // 2, w // 2, c
    convs.append((cin, filts[-1], 3, h, w, True))
    cin = filts[-1]
    for i in reversed(range(ns)):
        c = filts[i]
        # The 4x4 stride-2 transposed conv costs what the conv it is the
        # transpose of costs: its input's size times 16 Cin Cout.
        convs.append((cin, c, 4, h, w, True))
        h, w = h * 2, w * 2
        convs.append((c, c, 3, h, w, True))
        cin = c
    num_tex = l - 1 if model["layer0_texture_from_input"] else l
    if model["deep_heads_stopgrad_trunk"] and l > 1:
        heads = [f, 1, l - 1, (l - 1) * 3] + (
            [] if model["layer0_texture_from_input"] else [3])
    else:
        heads = [l] + ([num_tex * 3] if num_tex else [])
    for cout in heads:
        convs.append((f, cout, 3, h, w, True))
    fwd = sum(conv_flops(ci, co, k, oh, ow) for ci, co, k, oh, ow, _ in convs)
    bwd = sum(conv_flops(ci, co, k, oh, ow) * (1 + int(g))
              for ci, co, k, oh, ow, g in convs)
    return {"forward": fwd, "train": fwd + bwd}

