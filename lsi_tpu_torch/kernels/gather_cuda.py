"""Bilinear gather (K4): the CUDA kernels' wrappers and the autograd
Function that joins them.

Replaces the TPU kernel ``lsi_tpu/kernels/gather_pallas.py:
gather_pallas_diff``, in two modes: by default the exact, unwindowed,
unsnapped semantics of ``ops/gather.bilinear_sample`` (the JAX lax path);
with ``max_dy >= 0`` the TPU kernel's own (K4-W): snapped fractions and a
vertical window of ``max_dy`` rows around each coordinate row's base row
``r % fold_h`` (``fold_h`` defaults to the image height), checked as the
splat's (``splat_cuda.check_window``).

* ``gather_fwd`` launches ``lsi_gather_fwd`` of
  ``lsi_tpu_torch/csrc/splat_bwd.cu``: ``sampled`` and the in-image
  ``valid`` mass;
* ``gather_bwd_coords`` launches ``lsi_gather_bwd_coords``: the coordinate
  cotangent, recomputed from the corners instead of saved by the forward;
* the image cotangent, when the image requires grad, is the forward splat
  (K1 without weights or wsum: unsnapped, or snapped and windowed as the
  gather) of the ``sampled`` cotangent, as ``gather_pallas.py``'s
  backward does.

The image is read at (N, Hi, Wi, C) with coordinates (N, Hs, Ws, 2) of any
size: layers folded into Hs sample the same image, so nothing is repeated
per layer. A tensor on the CPU takes the plain version
(``ops/gather.py``, its VJP by autograd); a CUDA tensor launches the
kernel, and a failed build
or launch raises. A direct call on tensors that require grad raises:
differentiate through :class:`GatherFn`.
"""

from __future__ import annotations

import dataclasses

import torch

from lsi_tpu_torch.kernels import build
from lsi_tpu_torch.kernels.splat_cuda import (THREADS, Tiling, aligned,
                                              check_device, check_no_grad,
                                              check_tensors, check_tiling,
                                              check_window, splat)
from lsi_tpu_torch.ops.gather import bilinear_sample


def _check(image: torch.Tensor, coords: torch.Tensor) -> None:
    if image.ndim != 4 or coords.ndim != 4 or coords.shape[-1] != 2:
        raise ValueError(
            f"image must be (N, Hi, Wi, C) and coords (N, Hs, Ws, 2), got "
            f"{tuple(image.shape)} and {tuple(coords.shape)}")
    if image.shape[0] != coords.shape[0]:
        raise ValueError(f"batch sizes differ: image {image.shape[0]}, "
                         f"coords {coords.shape[0]}")
    if not 1 <= image.shape[-1] <= 8:
        raise ValueError(f"the kernel takes 1..8 channels, got {image.shape[-1]}")
    check_tensors({"image": image, "coords": coords}, image.device)


#: Rows per block of ``lsi_gather_fwd`` at most (``kMaxTileRows``).
MAX_TILE_ROWS = 4


@dataclasses.dataclass(frozen=True)
class GatherTiling(Tiling):
    """:class:`Tiling` of ``lsi_gather_fwd``: each block's ``tile[0]`` rows
    lie ``row_stride`` apart (see :func:`gather_tile_rows`)."""
    row_stride: int = 1


def gather_tiling(image_shape, coords_shape, *,
                  max_tile_rows: int = MAX_TILE_ROWS) -> GatherTiling:
    """``lsi_gather_fwd``'s launch for an (N, Hi, Wi, C) image sampled at
    (N, Hs, Ws, 2) coordinates.

    A block takes ``THREADS`` columns. Where the coordinates fold L <=
    ``max_tile_rows`` layers of Hi rows (Hs = L * Hi, the inverse warp),
    its rows are one row of each layer (they sample the same image rows);
    otherwise ``max_tile_rows`` neighbouring rows.
    """
    n, hi, wi, c = (int(v) for v in image_shape)
    _, hs, ws, _ = (int(v) for v in coords_shape)
    if not 1 <= max_tile_rows <= MAX_TILE_ROWS:
        raise ValueError(f"max_tile_rows must be 1..{MAX_TILE_ROWS}")
    if max(hs * ws * max(c, 2), hi * wi * c) >= 2**31:
        raise ValueError("an image's offsets must fit 32 bits")
    layers = hs // hi
    if hs % hi == 0 and 1 < layers <= max_tile_rows:
        row_stride, tile_rows = hi, layers
    else:
        row_stride, tile_rows = 1, min(max_tile_rows, hs)
    groups = -(-hs // (row_stride * tile_rows)) * row_stride
    return check_tiling(GatherTiling(
        block=(THREADS, 1), tile=(tile_rows, THREADS),
        grid=(-(-ws // THREADS), groups, n), smem_bytes=0, vec4=False,
        row_stride=row_stride))


def gather_tile_rows(tiling: GatherTiling, group: int, src_h: int):
    """The source rows of the blocks at ``blockIdx.y == group`` (the map
    ``gather_tile_row`` of ``csrc/splat_bwd.cu``)."""
    s, t = tiling.row_stride, tiling.tile[0]
    base = group // s * s * t + group % s
    return [r for r in range(base, base + s * t, s) if r < src_h]


def _sizes(image: torch.Tensor, coords: torch.Tensor):
    n, hi, wi, c = image.shape
    _, hs, ws, _ = coords.shape
    return n, hs, ws, c, hi, wi


def gather_window(image: torch.Tensor, coords: torch.Tensor, max_dy: int,
                  fold_h=None):
    """The gather kernels' window arguments ``(max_dy, fold_h)``: (-1, 1)
    for no window; raises ValueError where the coordinate rows are not a
    multiple of ``fold_h`` (default: the image height) or ``fold_h``
    exceeds the image."""
    max_dy, fold_h, _ = check_window(coords.shape[1], image.shape[1],
                                     max_dy, fold_h)
    return max_dy, fold_h


def gather_fwd(image: torch.Tensor, coords: torch.Tensor, max_dy: int = -1,
               fold_h=None):
    """Bilinear-gather ``image`` at ``coords``.

    Args:
      image:  (N, Hi, Wi, C) float32, C in 1..8.
      coords: (N, Hs, Ws, 2) float32 pixel [x, y] into the image.
      max_dy, fold_h: with ``max_dy >= 0``, the TPU kernel's gather (module
        docstring); -1 (the default) is the exact gather.
    Returns:
      sampled (N, Hs, Ws, C), 0 outside the image (and the window), and
      valid (N, Hs, Ws, 1), the bilinear mass inside them; float32.
    """
    _check(image, coords)
    check_no_grad("gather_fwd", image, coords)
    window = gather_window(image, coords, max_dy, fold_h)
    if not check_device(image.device):
        return bilinear_sample(image, coords, *window)

    return _launch_gather_fwd(image, coords, window=window)


def _launch_gather_fwd(image, coords, tiling=None, window=(-1, 1)):
    """Launch ``lsi_gather_fwd`` on CUDA tensors with ``tiling`` (default:
    :func:`gather_tiling`'s choice) and ``window`` ((max_dy, fold_h),
    checked by the caller) and count the launch."""
    n, hs, ws, c, hi, wi = _sizes(image, coords)
    coords = aligned(coords, 8)  # read as float2
    sampled = torch.empty((n, hs, ws, c), dtype=torch.float32,
                          device=image.device)
    valid = torch.empty((n, hs, ws, 1), dtype=torch.float32,
                        device=image.device)
    if tiling is None:
        tiling = gather_tiling(image.shape, coords.shape)
    build.launch("splat_bwd", "lsi_gather_fwd", image.device,
                 image.data_ptr(), coords.data_ptr(), sampled.data_ptr(),
                 valid.data_ptr(), n, hs, ws, c, hi, wi, tiling.grid[1],
                 tiling.tile[0], tiling.row_stride, *window)
    gather_fwd.launches += 1
    gather_fwd.window_launches += window[0] >= 0
    return sampled, valid


#: Kernel launches made through :func:`gather_fwd` (CPU calls do not count),
#: and how many of them were windowed.
gather_fwd.launches = 0
gather_fwd.window_launches = 0


def _plain_coords_vjp(image, coords, g_sampled, g_valid, max_dy: int = -1,
                      fold_h=None):
    """The plain coordinate VJP: autograd through ``bilinear_sample``,
    windowed as :func:`gather_fwd` is."""
    window = gather_window(image, coords, max_dy, fold_h)
    crd = coords.detach().requires_grad_()
    with torch.enable_grad():
        sampled, valid = bilinear_sample(image.detach(), crd, *window)
        (d_coords,) = torch.autograd.grad((sampled, valid), crd,
                                          (g_sampled, g_valid))
    return d_coords


def gather_bwd_coords(image: torch.Tensor, coords: torch.Tensor,
                      g_sampled: torch.Tensor, g_valid: torch.Tensor,
                      max_dy: int = -1, fold_h=None) -> torch.Tensor:
    """The coordinate cotangent of :func:`gather_fwd`, (N, Hs, Ws, 2):
    ``sum_c g_sampled_c * dS0_c/dx + g_valid * dvalid/dx`` (and y), in
    the forward's window; with a window, 0 where a fraction is snapped."""
    _check(image, coords)
    n, hs, ws, c, hi, wi = _sizes(image, coords)
    want = {"g_sampled": (n, hs, ws, c), "g_valid": (n, hs, ws, 1)}
    for name, t in (("g_sampled", g_sampled), ("g_valid", g_valid)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(t.shape)}")
    check_tensors({"g_sampled": g_sampled, "g_valid": g_valid}, image.device)
    check_no_grad("gather_bwd_coords", image, coords, g_sampled, g_valid)
    window = gather_window(image, coords, max_dy, fold_h)
    if not check_device(image.device):
        return _plain_coords_vjp(image, coords, g_sampled, g_valid, *window)

    d_coords = torch.empty_like(coords)
    build.launch("splat_bwd", "lsi_gather_bwd_coords", image.device,
                 image.data_ptr(), coords.data_ptr(), g_sampled.data_ptr(),
                 g_valid.data_ptr(), d_coords.data_ptr(), n, hs, ws, c, hi,
                 wi, *window)
    gather_bwd_coords.launches += 1
    gather_bwd_coords.window_launches += window[0] >= 0
    return d_coords


#: Kernel launches made through :func:`gather_bwd_coords` (CPU calls do
#: not count), and how many of them were windowed.
gather_bwd_coords.launches = 0
gather_bwd_coords.window_launches = 0


class GatherFn(torch.autograd.Function):
    """Differentiable gather: ``GatherFn.apply(image, coords) ->
    (sampled, valid)``; ``GatherFn.apply(image, coords, max_dy, fold_h)``
    is the windowed, snapped gather (:func:`gather_fwd`), whose gradients
    are the window's too. The backward computes only the gradients
    autograd asks for: the coordinates' by ``gather_bwd_coords``, the
    image's by the forward splat of the ``sampled`` cotangent (unsnapped,
    or snapped and windowed as the gather).
    """

    @staticmethod
    def forward(ctx, image, coords, max_dy=-1, fold_h=None):
        ctx.window = gather_window(image, coords, max_dy, fold_h)
        ctx.save_for_backward(image, coords)
        return gather_fwd(image, coords, *ctx.window)

    @staticmethod
    def backward(ctx, g_sampled, g_valid):
        image, coords = ctx.saved_tensors
        max_dy, fold_h = ctx.window
        d_image = d_coords = None
        g_sampled = g_sampled.float().contiguous()
        if ctx.needs_input_grad[0]:
            # ``valid`` does not depend on the image: no term from it. The
            # cotangent is splatted unweighted, and no wsum is made.
            d_image, _ = splat(g_sampled, coords, None, image.shape[1:3],
                               snap=max_dy >= 0, max_dy=max_dy,
                               fold_h=fold_h)
        if ctx.needs_input_grad[1]:
            d_coords = gather_bwd_coords(image, coords, g_sampled,
                                         g_valid.float().contiguous(),
                                         max_dy, fold_h)
        return d_image, d_coords, None, None
