"""Bilinear gather (K4): the CUDA kernels' wrappers and the autograd
Function that joins them.

Replaces the TPU kernel ``lsi_tpu/kernels/gather_pallas.py:
gather_pallas_diff`` with the exact, unwindowed, unsnapped semantics of
``ops/gather.bilinear_sample`` (the JAX lax path):

* ``gather_fwd`` launches ``lsi_gather_fwd`` of
  ``lsi_tpu_torch/csrc/splat_bwd.cu``: ``sampled`` and the in-image
  ``valid`` mass;
* ``gather_bwd_coords`` launches ``lsi_gather_bwd_coords``: the coordinate
  cotangent, recomputed from the corners instead of saved by the forward;
* the image cotangent, when the image requires grad, is the forward splat
  (K1, unsnapped, unit weights) of the ``sampled`` cotangent, as
  ``gather_pallas.py``'s backward does.

The image is read at (N, Hi, Wi, C) with coordinates (N, Hs, Ws, 2) of any
size: layers folded into Hs sample the same image, so nothing is repeated
per layer. A tensor on the CPU takes the plain version
(``ops/gather.py``, its VJP by autograd); a CUDA tensor launches the
kernel, and a failed build
or launch raises. A direct call on tensors that require grad raises:
differentiate through :class:`GatherFn`.
"""

from __future__ import annotations

import torch

from lsi_tpu_torch.kernels import build
from lsi_tpu_torch.kernels.splat_cuda import (check_device, check_no_grad,
                                              check_tensors, splat)
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


def _sizes(image: torch.Tensor, coords: torch.Tensor):
    n, hi, wi, c = image.shape
    _, hs, ws, _ = coords.shape
    return n, hs, ws, c, hi, wi


def gather_fwd(image: torch.Tensor, coords: torch.Tensor):
    """Bilinear-gather ``image`` at ``coords``.

    Args:
      image:  (N, Hi, Wi, C) float32, C in 1..8.
      coords: (N, Hs, Ws, 2) float32 pixel [x, y] into the image.
    Returns:
      sampled (N, Hs, Ws, C), 0 outside the image, and valid
      (N, Hs, Ws, 1), the in-image bilinear mass; float32.
    """
    _check(image, coords)
    check_no_grad("gather_fwd", image, coords)
    if not check_device(image.device):
        return bilinear_sample(image, coords)

    n, hs, ws, c, hi, wi = _sizes(image, coords)
    sampled = torch.empty((n, hs, ws, c), dtype=torch.float32,
                          device=image.device)
    valid = torch.empty((n, hs, ws, 1), dtype=torch.float32,
                        device=image.device)
    build.launch("splat_bwd", "lsi_gather_fwd", image.device,
                 image.data_ptr(), coords.data_ptr(), sampled.data_ptr(),
                 valid.data_ptr(), n, hs, ws, c, hi, wi)
    gather_fwd.launches += 1
    return sampled, valid


#: Kernel launches made through :func:`gather_fwd` (CPU calls do not count).
gather_fwd.launches = 0


def _plain_coords_vjp(image, coords, g_sampled, g_valid):
    """The plain coordinate VJP: autograd through ``bilinear_sample``."""
    crd = coords.detach().requires_grad_()
    with torch.enable_grad():
        sampled, valid = bilinear_sample(image.detach(), crd)
        (d_coords,) = torch.autograd.grad((sampled, valid), crd,
                                          (g_sampled, g_valid))
    return d_coords


def gather_bwd_coords(image: torch.Tensor, coords: torch.Tensor,
                      g_sampled: torch.Tensor,
                      g_valid: torch.Tensor) -> torch.Tensor:
    """The coordinate cotangent of :func:`gather_fwd`, (N, Hs, Ws, 2):
    ``sum_c g_sampled_c * dS0_c/dx + g_valid * dvalid/dx`` (and y)."""
    _check(image, coords)
    n, hs, ws, c, hi, wi = _sizes(image, coords)
    want = {"g_sampled": (n, hs, ws, c), "g_valid": (n, hs, ws, 1)}
    for name, t in (("g_sampled", g_sampled), ("g_valid", g_valid)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(t.shape)}")
    check_tensors({"g_sampled": g_sampled, "g_valid": g_valid}, image.device)
    check_no_grad("gather_bwd_coords", image, coords, g_sampled, g_valid)
    if not check_device(image.device):
        return _plain_coords_vjp(image, coords, g_sampled, g_valid)

    d_coords = torch.empty_like(coords)
    build.launch("splat_bwd", "lsi_gather_bwd_coords", image.device,
                 image.data_ptr(), coords.data_ptr(), g_sampled.data_ptr(),
                 g_valid.data_ptr(), d_coords.data_ptr(), n, hs, ws, c, hi,
                 wi)
    gather_bwd_coords.launches += 1
    return d_coords


#: Kernel launches made through :func:`gather_bwd_coords` (CPU calls do
#: not count).
gather_bwd_coords.launches = 0


class GatherFn(torch.autograd.Function):
    """Differentiable gather: ``GatherFn.apply(image, coords) ->
    (sampled, valid)``. The backward computes only the gradients autograd
    asks for: the coordinates' by ``gather_bwd_coords``, the image's by
    the unsnapped forward splat of the ``sampled`` cotangent.
    """

    @staticmethod
    def forward(ctx, image, coords):
        ctx.save_for_backward(image, coords)
        return gather_fwd(image, coords)

    @staticmethod
    def backward(ctx, g_sampled, g_valid):
        image, coords = ctx.saved_tensors
        d_image = d_coords = None
        g_sampled = g_sampled.float().contiguous()
        if ctx.needs_input_grad[0]:
            # ``valid`` does not depend on the image: no term from it.
            ones = torch.ones(coords.shape[:-1] + (1,), dtype=torch.float32,
                              device=coords.device)
            d_image, _ = splat(g_sampled, coords, ones, image.shape[1:3],
                               snap=False)
        if ctx.needs_input_grad[1]:
            d_coords = gather_bwd_coords(image, coords, g_sampled,
                                         g_valid.float().contiguous())
        return d_image, d_coords
