"""Forward bilinear splat (K1) and its VJP (K2 + K3): the CUDA kernels'
wrappers and the autograd Function that joins them.

The kernels are hand-written for sm_90a and bound through ctypes:

* ``splat`` launches ``lsi_tpu_torch/csrc/splat_fwd.cu`` (K1), replacing
  ``lsi_tpu/kernels/splat_pallas.py:_splat_kernel``;
* ``splat_vjp`` launches ``lsi_splat_vjp`` of
  ``lsi_tpu_torch/csrc/splat_bwd.cu``, replacing ``_splat_bwd_kernel``
  (K2) with the combine of ``splat_pallas_diff``'s backward (K3) fused in.

Both follow the exact semantics of ``ops/splat.splat_bilinear`` (the JAX
lax path), unwindowed or, with ``max_dy >= 0``, with the TPU kernel's
vertical window (``fold_h``, ``base_offset``; the height-sharded render's
splat); the source notes say what bounds each kernel on the card. A tensor on the CPU takes the plain version (``ops/splat.py``, its
VJP by autograd); a CUDA tensor launches the kernel, and a failed build or
launch raises. There is no fallback from one to the other.

The kernels record no autograd node, so a direct call on tensors that
require grad raises: differentiate through :class:`SplatFn`.
"""

from __future__ import annotations

import dataclasses

import torch

from lsi_tpu_torch.kernels import build
from lsi_tpu_torch.ops.splat import splat_bilinear


def check_no_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise where a kernel call would silently drop a gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} launches a kernel that records no autograd node, and an "
            "input requires grad: call it through its autograd Function "
            "(SplatFn / GatherFn) or under torch.no_grad()")


def check_tensors(tensors, device: torch.device) -> None:
    """float32, contiguous, all on ``device``."""
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")


def check_device(device: torch.device) -> bool:
    """True for a CUDA device, False for the CPU; raise on anything else."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the kernels run on cpu or cuda, not {device}")
    return device.type == "cuda"


def aligned(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """``t``, or a fresh copy of it when its data is not ``nbytes``-aligned
    (a view into another tensor's storage may start anywhere)."""
    return t if t.data_ptr() % nbytes == 0 else t.clone()


#: Threads per block of every tiled kernel (``kThreads`` in the sources).
THREADS = 256
#: Shared memory a block of an H100 may use (227 KB).
MAX_SMEM_BYTES = 232_448
#: CUDA's grid limits for blockIdx.x, .y and .z.
MAX_GRID = (2**31 - 1, 65_535, 65_535)


@dataclasses.dataclass(frozen=True)
class Tiling:
    """A tiled kernel's launch: ``block`` (x, y) threads, ``tile`` (rows,
    columns) of source pixels per block, ``grid`` (x, y, z) blocks,
    ``smem_bytes`` of dynamic shared memory, ``vec4`` the float4 path."""
    block: tuple
    tile: tuple
    grid: tuple
    smem_bytes: int
    vec4: bool


def check_tiling(t: Tiling) -> Tiling:
    """Raise where ``t`` breaks CUDA's limits; return it."""
    if t.block[0] * t.block[1] != THREADS:
        raise ValueError(f"{t.block} is not {THREADS} threads")
    if not 0 <= t.smem_bytes <= MAX_SMEM_BYTES:
        raise ValueError(f"{t.smem_bytes} B of shared memory")
    if any(not 1 <= g <= m for g, m in zip(t.grid, MAX_GRID)):
        raise ValueError(f"grid {t.grid} beyond CUDA's limits {MAX_GRID}")
    return t


def splat_tiling(values_shape, out_hw, aligned16: bool, *,
                 block_x: int = 128, rows_per_thread: int = 2,
                 smem_bytes: int = 32 * 1024) -> Tiling:
    """K1's launch for values (N, Hs, Ws, C) splatted into ``out_hw``.

    Each block takes ``block_x`` columns by ``THREADS // block_x *
    rows_per_thread`` source rows of one image and accumulates in
    ``smem_bytes`` of shared memory when its targets' bounding box fits
    (``csrc/splat_fwd.cu``). ``aligned16``: values and accum start on a
    16-byte boundary; with C = 4 that takes the float4 path.
    """
    n, hs, ws, c = (int(v) for v in values_shape)
    out_h, out_w = (int(v) for v in out_hw)
    if max(hs * ws * max(c, 2), out_h * out_w * (c + 1)) >= 2**31:
        raise ValueError("an image's offsets must fit 32 bits")
    block_y = THREADS // block_x
    tile_h = block_y * rows_per_thread
    return check_tiling(Tiling(
        block=(block_x, block_y), tile=(tile_h, block_x),
        grid=(-(-ws // block_x), -(-hs // tile_h), n),
        smem_bytes=smem_bytes, vec4=c == 4 and aligned16))


def check_window(src_h: int, out_h: int, max_dy: int, fold_h=None,
                 base_offset: int = 0):
    """The kernels' window arguments ``(max_dy, fold_h, base_offset)``:
    ``fold_h`` defaults to ``out_h``, and no window (``max_dy < 0``) is
    ``(-1, 1, 0)``. Raises ValueError where the TPU kernel does
    (``lsi_tpu/kernels/splat_pallas.py:262-271``)."""
    if max_dy < 0:
        return (-1, 1, 0)
    fold_h = out_h if fold_h is None else int(fold_h)
    if fold_h <= 0 or src_h % fold_h:
        raise ValueError(
            f"folded-row contract violated: source rows {src_h} must be a "
            f"multiple of fold_h {fold_h} (a source row r splats around "
            "target base row r % fold_h + base_offset)")
    if base_offset < 0 or base_offset + fold_h > out_h:
        raise ValueError(
            f"base rows [{base_offset}, {base_offset + fold_h}) must lie "
            f"inside the target height {out_h}")
    return (int(max_dy), fold_h, int(base_offset))


def window_base_rows(src_h: int, out_h: int, max_dy: int,
                     fold_h=None, base_offset: int = 0):
    """The windowed splat's base row of each source row, ``r % fold_h +
    base_offset``, as an int64 tensor on the CPU (the plain version's
    ``base_rows``); None for ``max_dy < 0`` (no window). Raises as
    :func:`check_window` does."""
    max_dy, fold_h, base_offset = check_window(src_h, out_h, max_dy, fold_h,
                                               base_offset)
    if max_dy < 0:
        return None
    return torch.arange(src_h) % fold_h + base_offset


def _check(values: torch.Tensor, coords: torch.Tensor,
           weights: torch.Tensor, out_hw) -> None:
    if values.ndim != 4:
        raise ValueError(f"values must be (N, Hs, Ws, C), got {tuple(values.shape)}")
    n, hs, ws, c = values.shape
    want = {"coords": (n, hs, ws, 2), "weights": (n, hs, ws, 1)}
    for name, t in (("coords", coords), ("weights", weights)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(t.shape)}")
    check_tensors({"values": values, "coords": coords, "weights": weights},
                  values.device)
    if not 1 <= c <= 8:
        raise ValueError(f"the kernel takes 1..8 channels, got {c}")
    out_h, out_w = out_hw
    if out_h <= 0 or out_w <= 0:
        raise ValueError(f"out_hw must be positive, got {out_hw}")


def splat(values: torch.Tensor, coords: torch.Tensor, weights: torch.Tensor,
          out_hw, snap: bool = True, max_dy: int = -1, fold_h=None,
          base_offset: int = 0):
    """Forward-splat ``values`` into an ``out_hw`` image (K1).

    Args:
      values:  (N, Hs, Ws, C) float32, C in 1..8; layers may be folded into
        Hs, the targets come from ``coords`` alone.
      coords:  (N, Hs, Ws, 2) float32 target pixel [x, y].
      weights: (N, Hs, Ws, 1) float32.
      out_hw:  (out_h, out_w).
      snap: snap the bilinear fractions (the render); False gives the
        transpose of the unsnapped gather (``GatherFn``'s image gradient).
      max_dy, fold_h, base_offset: with ``max_dy >= 0``, drop every corner
        whose row lies outside ``[base - max_dy, base + max_dy + 1]``,
        ``base = r % fold_h + base_offset`` for source row r
        (:func:`window_base_rows`); -1 (the default) is no window.
    Returns:
      accum (N, out_h, out_w, C) and wsum (N, out_h, out_w, 1), float32.
    """
    _check(values, coords, weights, out_hw)
    check_no_grad("splat", values, coords, weights)
    window = check_window(values.shape[1], int(out_hw[0]), max_dy, fold_h,
                          base_offset)
    if not check_device(values.device):
        return splat_bilinear(
            values, coords, weights, out_hw, snap=snap,
            max_dy_window=None if window[0] < 0 else window[0],
            base_rows=window_base_rows(values.shape[1], int(out_hw[0]),
                                       *window))

    return _launch_splat(values, coords, weights, out_hw, snap,
                         window=window)


def _launch_splat(values, coords, weights, out_hw, snap, tiling=None,
                  window=(-1, 1, 0)):
    """Launch K1 on CUDA tensors with ``tiling`` (default:
    :func:`splat_tiling`'s choice) and ``window`` ((max_dy, fold_h,
    base_offset), checked by the caller) and count the launch."""
    n, hs, ws, c = values.shape
    out_h, out_w = (int(v) for v in out_hw)
    coords = aligned(coords, 8)  # read as float2
    accum = torch.zeros((n, out_h, out_w, c), dtype=torch.float32,
                        device=values.device)
    wsum = torch.zeros((n, out_h, out_w, 1), dtype=torch.float32,
                       device=values.device)
    if tiling is None:
        tiling = splat_tiling(values.shape, out_hw, aligned16=all(
            t.data_ptr() % 16 == 0 for t in (values, accum)))
    build.launch("splat_fwd", "lsi_splat_fwd", values.device,
                 values.data_ptr(), coords.data_ptr(), weights.data_ptr(),
                 accum.data_ptr(), wsum.data_ptr(), n, hs, ws, c, out_h,
                 out_w, int(snap), tiling.block[0], tiling.tile[0],
                 tiling.smem_bytes, int(tiling.vec4), *window)
    splat.launches += 1
    splat.window_launches += window[0] >= 0
    return accum, wsum


#: Kernel launches made through :func:`splat` (CPU calls do not count),
#: and how many of them were windowed.
splat.launches = 0
splat.window_launches = 0


def _plain_vjp(values, coords, weights, g_accum, g_wsum, out_hw, needs,
               max_dy: int = -1, fold_h=None, base_offset: int = 0):
    """The plain VJP: autograd through ``splat_bilinear``, windowed as
    :func:`splat` is."""
    base = window_base_rows(values.shape[1], int(out_hw[0]), max_dy, fold_h,
                            base_offset)
    inputs = [t.detach().requires_grad_(need)
              for t, need in zip((values, coords, weights), needs)]
    with torch.enable_grad():
        accum, wsum = splat_bilinear(
            *inputs, out_hw, max_dy_window=None if base is None else max_dy,
            base_rows=base)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad((accum, wsum), wanted,
                                         (g_accum, g_wsum)))
    return tuple(next(grads) if need else None for need in needs)


def splat_vjp(values: torch.Tensor, coords: torch.Tensor,
              weights: torch.Tensor, g_accum: torch.Tensor,
              g_wsum: torch.Tensor, out_hw, needs=(True, True, True),
              max_dy: int = -1, fold_h=None, base_offset: int = 0):
    """The splat's VJP (K2 + K3) at the forward's inputs.

    Args:
      values, coords, weights: the forward's inputs (see :func:`splat`).
      g_accum: (N, out_h, out_w, C) and g_wsum (N, out_h, out_w, 1)
        float32 cotangents of the forward's outputs.
      needs: which of (d_values, d_coords, d_weights) to compute.
      max_dy, fold_h, base_offset: the forward's window (:func:`splat`).
    Returns:
      (d_values, d_coords, d_weights), shaped as the inputs, None where not
      needed. ``d_coords`` is 0 where a fraction lies in a snap zone.
    """
    _check(values, coords, weights, out_hw)
    n, hs, ws, c = values.shape
    out_h, out_w = (int(v) for v in out_hw)
    want = {"g_accum": (n, out_h, out_w, c), "g_wsum": (n, out_h, out_w, 1)}
    for name, t in (("g_accum", g_accum), ("g_wsum", g_wsum)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(t.shape)}")
    check_tensors({"g_accum": g_accum, "g_wsum": g_wsum}, values.device)
    check_no_grad("splat_vjp", values, coords, weights, g_accum, g_wsum)
    needs = tuple(bool(x) for x in needs)
    window = check_window(hs, out_h, max_dy, fold_h, base_offset)
    if not check_device(values.device):
        return _plain_vjp(values, coords, weights, g_accum, g_wsum, out_hw,
                          needs, *window)

    outs = [torch.empty_like(t) if need else None
            for t, need in zip((values, coords, weights), needs)]
    ptrs = [0 if t is None else t.data_ptr() for t in outs]
    build.launch("splat_bwd", "lsi_splat_vjp", values.device,
                 values.data_ptr(), coords.data_ptr(), weights.data_ptr(),
                 g_accum.data_ptr(), g_wsum.data_ptr(), *ptrs, n, hs, ws, c,
                 out_h, out_w, *window)
    splat_vjp.launches += 1
    splat_vjp.window_launches += window[0] >= 0
    return tuple(outs)


#: Kernel launches made through :func:`splat_vjp` (CPU calls do not count),
#: and how many of them were windowed.
splat_vjp.launches = 0
splat_vjp.window_launches = 0


class SplatFn(torch.autograd.Function):
    """Differentiable splat: K1 forward, K2 + K3 backward.

    ``SplatFn.apply(values, coords, weights, out_hw) -> (accum, wsum)``;
    ``SplatFn.apply(values, coords, weights, out_hw, max_dy, fold_h,
    base_offset)`` is the windowed splat (:func:`splat`), whose gradients
    are the window's too. The backward computes only the gradients
    autograd asks for.
    """

    @staticmethod
    def forward(ctx, values, coords, weights, out_hw, max_dy=-1, fold_h=None,
                base_offset=0):
        ctx.out_hw = tuple(int(v) for v in out_hw)
        ctx.window = dict(max_dy=max_dy, fold_h=fold_h,
                          base_offset=base_offset)
        ctx.save_for_backward(values, coords, weights)
        return splat(values, coords, weights, ctx.out_hw, **ctx.window)

    @staticmethod
    def backward(ctx, g_accum, g_wsum):
        needs = ctx.needs_input_grad[:3]
        if not any(needs):
            return None, None, None, None, None, None, None
        values, coords, weights = ctx.saved_tensors
        d_values, d_coords, d_weights = splat_vjp(
            values, coords, weights, g_accum.float().contiguous(),
            g_wsum.float().contiguous(), ctx.out_hw, needs, **ctx.window)
        return d_values, d_coords, d_weights, None, None, None, None
