"""Forward bilinear splat (scatter-add) and its tent sums: the plain
PyTorch versions.

PyTorch counterpart of ``lsi_tpu/ops/splat.py`` (``method="scatter"``
and the deterministic ``method="sort"``, with the optional per-corner
vertical window, ``max_dy_window`` and ``base_rows``). ``splat_bilinear``
is the CPU path of ``kernels.splat_cuda.splat`` (K1, and K1-D for
``"sort"``) and, through autograd, of its VJP (K2 + K3), windowed or not;
``tent_sums`` is the plain form of the per-pixel sums those kernels and
the gather kernels compute. The CUDA kernels are held against these on
the card.
"""

from __future__ import annotations

import torch

# Bilinear fractions within MIN_FRACTION of an integer are snapped to it
# (see snap_fraction).
MIN_FRACTION = 1e-4


def snap_fraction(f: torch.Tensor) -> torch.Tensor:
    """Snap bilinear fractions within MIN_FRACTION of 0/1 to exactly 0/1.

    float32 rounding of near-integer projected coordinates yields ~1e-5
    phantom fractions that the soft z-buffer's exp weights can amplify
    above a neighbouring pixel's own weight; snapping per axis removes them
    (same semantics as the JAX package and its numpy oracle).
    """
    f = torch.where(f < MIN_FRACTION, torch.zeros_like(f), f)
    return torch.where(f > 1.0 - MIN_FRACTION, torch.ones_like(f), f)


def splat_bilinear(values: torch.Tensor, coords: torch.Tensor,
                   weights: torch.Tensor, out_hw, snap: bool = True,
                   max_dy_window=None, base_rows=None,
                   method: str = "scatter"):
    """Forward-splat per-pixel values into a target image.

    Args:
      values:  (N, Hs, Ws, C) source values.
      coords:  (N, Hs, Ws, 2) target pixel [x, y] for each source pixel.
      weights: (N, Hs, Ws, 1) per-source-pixel weight, or None: the
        values splatted unweighted and no wsum (the gather's image
        gradient).
      out_hw:  (out_h, out_w) target size.
      snap: snap the bilinear fractions (the render's splat). Without it
        the splat is the exact transpose of ``ops.gather.bilinear_sample``
        (the gather's image gradient).
      max_dy_window: with an int m, a corner whose target row ``yi`` has
        ``yi - base`` outside ``[-m, m + 1]`` is dropped, corner by corner
        (the windowed contract of the TPU splat kernel, which the
        height-sharded render relies on). ``base`` is the source row's
        base row: ``base_rows`` (Hs,) integers, or ``row % out_h``.
      method: "scatter" (one ``index_add_`` of every corner) or "sort"
        (JAX's deterministic path: a stable argsort of the corner targets,
        corner-major ``(4, N, P)``, then each target's run summed in that
        order from 0.0; bitwise repeatable on the CPU).
    Returns:
      accum (N, out_h, out_w, C) float32 sum of ``w * frac * v`` and
      wsum (N, out_h, out_w, 1) float32 sum of ``w * frac`` (None without
      weights).
    """
    if method not in ("scatter", "sort"):
        raise ValueError(f"unknown splat method: {method!r}")
    out_h, out_w = out_hw
    n, _, _, c = values.shape
    idx, contrib = corner_contributions(values, coords, weights, out_hw,
                                        snap, max_dy_window, base_rows)
    if method == "sort":
        # The trash row sorts last, where JAX's index -1 sorts first into
        # a segment it slices off: the live targets' runs keep their
        # corner-major order either way. index_add_ on the CPU adds its
        # rows in index order, so each run is summed in sorted order.
        order = torch.argsort(idx, stable=True)
        idx, contrib = idx[order], contrib[order]
    trash = n * out_h * out_w
    out = torch.zeros(trash + 1, contrib.shape[-1], dtype=torch.float32,
                      device=values.device)
    out.index_add_(0, idx, contrib)
    out = out[:trash].reshape(n, out_h, out_w, -1)
    return out[..., :c], (None if weights is None else out[..., c:])


def corner_contributions(values: torch.Tensor, coords: torch.Tensor,
                         weights, out_hw, snap: bool = True,
                         max_dy_window=None, base_rows=None):
    """The flat scatter :func:`splat_bilinear` sums, corner-major:
    ``(idx (4 N P,) int64, contrib (4 N P, C + 1) float32)``, the target
    index of each corner (``N * out_h * out_w``, one trash row past the
    end, where it is dropped) and its contribution ``[w v, w] * frac``
    (``v * frac`` without weights)."""
    out_h, out_w = out_hw
    n, hs, ws, c = values.shape
    p = hs * ws
    dev = values.device

    if weights is None:
        payload = values.float().reshape(n, p, c)
    else:
        w32 = weights.float().reshape(n, p, 1)
        payload = torch.cat([values.float().reshape(n, p, c) * w32, w32],
                            dim=-1)
    planes = payload.shape[-1]

    x = coords[..., 0].float().reshape(n, p)
    y = coords[..., 1].float().reshape(n, p)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    if snap:
        fx = snap_fraction(fx)
        fy = snap_fraction(fy)

    # Out-of-image corners go to one trash row past the end. The bounds
    # test is made in float, and only in-bounds coordinates reach the
    # integer conversion: projected coordinates reach ~1e6 (and may be
    # inf/nan), where a float->int cast is undefined.
    trash = n * out_h * out_w
    batch_off = (torch.arange(n, device=dev, dtype=torch.int64)
                 * (out_h * out_w))[:, None]
    if max_dy_window is not None:
        if base_rows is None:
            base_rows = torch.arange(hs, device=dev) % out_h
        # Per source pixel, as float: the test below is exact, since it
        # only decides for rows inside the image (small integers).
        base = base_rows.to(device=dev, dtype=torch.float32)[:, None] \
            .expand(hs, ws).reshape(1, p)
    zero = torch.zeros_like(x)
    idxs = []
    wts = []
    for dy, dx, frac in ((0, 0, (1.0 - fx) * (1.0 - fy)),
                         (0, 1, fx * (1.0 - fy)),
                         (1, 0, (1.0 - fx) * fy),
                         (1, 1, fx * fy)):
        xi = x0 + dx
        yi = y0 + dy
        inb = (xi >= 0) & (xi <= out_w - 1) & (yi >= 0) & (yi <= out_h - 1)
        if max_dy_window is not None:
            ky = yi - base
            inb &= (ky >= -max_dy_window) & (ky <= max_dy_window + 1)
        lin = (batch_off
               + torch.where(inb, yi, zero).to(torch.int64) * out_w
               + torch.where(inb, xi, zero).to(torch.int64))
        idxs.append(torch.where(inb, lin, torch.full_like(lin, trash)))
        wts.append(frac * inb)

    idx = torch.stack(idxs).reshape(-1)                     # (4*N*P,)
    contrib = (payload[None] * torch.stack(wts)[..., None]).reshape(-1,
                                                                     planes)
    return idx, contrib


def corner_reads(image: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor):
    """``image`` (N, H, W, C) read at the four integer corners
    (x0 + dx, y0 + dy) of each (N, P) float corner, in the order 00, 01
    (x + 1), 10 (y + 1), 11; 0 where the corner lies outside the image.

    The bounds test is made in float and only clamped, finite coordinates
    reach the integer conversion (coordinates reach +-1e6, inf or nan).
    """
    n, h, w, c = image.shape
    flat = image.reshape(n, h * w, c)
    reads = []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        xi = x0 + dx
        yi = y0 + dy
        inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        lin = (yi.clamp(0, h - 1).nan_to_num(0.0).to(torch.int64) * w
               + xi.clamp(0, w - 1).nan_to_num(0.0).to(torch.int64))
        g = torch.gather(flat, 1, lin[..., None].expand(-1, -1, c))
        reads.append(g * inb[..., None])
    return reads


def tent_sums(image: torch.Tensor, coords: torch.Tensor, snap: bool):
    """Per-pixel tent sums of ``image`` over each coordinate's bilinear
    neighbourhood, by four gathers.

        S0 = sum_k frac_k * I_k              (the bilinear gather)
        SX = (1 - fy)(I01 - I00) + fy (I11 - I10)   (d S0 / d x)
        SY = (1 - fx)(I10 - I00) + fx (I11 - I01)   (d S0 / d y)

    with I_k the image at corner k (0 outside the image) and the fractions
    snapped when ``snap`` (the splat's VJP) or not (the gather).

    Args:
      image:  (N, H, W, C) float32.
      coords: (N, Hs, Ws, 2) pixel [x, y] into the image.
    Returns:
      S0, SX, SY, each (N, Hs, Ws, C) float32.
    """
    n, hs, ws, _ = coords.shape
    x = coords[..., 0].float().reshape(n, -1)
    y = coords[..., 1].float().reshape(n, -1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    if snap:
        fx = snap_fraction(fx)
        fy = snap_fraction(fy)
    i00, i01, i10, i11 = corner_reads(image.float(), x0, y0)
    s0 = ((1 - fx) * (1 - fy) * i00 + fx * (1 - fy) * i01
          + (1 - fx) * fy * i10 + fx * fy * i11)
    sx = (1 - fy) * (i01 - i00) + fy * (i11 - i10)
    sy = (1 - fx) * (i10 - i00) + fx * (i11 - i01)
    shape = (n, hs, ws, image.shape[-1])
    return s0.reshape(shape), sx.reshape(shape), sy.reshape(shape)
