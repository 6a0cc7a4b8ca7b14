"""Forward bilinear splat (K1) and its VJP (K2 + K3): the CUDA kernels'
wrappers and the autograd Function that joins them.

The kernels are hand-written for sm_90a and bound through ctypes:

* ``splat`` launches K1, replacing
  ``lsi_tpu/kernels/splat_pallas.py:_splat_kernel``: the box kernel
  ``lsi_splat_fwd`` (``lsi_tpu_torch/csrc/splat_fwd.cu``), unwindowed or
  windowed, or, for a windowed splat whose bands re-read few rows, the
  band kernel ``lsi_splat_band`` (``lsi_tpu_torch/csrc/splat_band.cu``),
  launched as :func:`band_tiling` plans (:func:`use_band` gives the
  rule);
* ``splat(..., deterministic=True)`` launches K1-D, the deterministic
  splat of ``lsi_tpu_torch/csrc/splat_sort.cu`` (a counting sort of the
  live corners by target, then each target's run summed in ascending
  corner position; every step a kernel of that file, launched as
  :func:`sort_plan` says), replacing the sort branch of
  ``lsi_tpu/ops/splat.py:splat_bilinear`` (``method="sort"``): the same
  function as K1, bitwise repeatable;
* ``splat_vjp`` launches ``lsi_splat_vjp`` of
  ``lsi_tpu_torch/csrc/splat_bwd.cu``, replacing ``_splat_bwd_kernel``
  (K2) with the combine of ``splat_pallas_diff``'s backward (K3) fused in.

All follow the exact semantics of ``ops/splat.splat_bilinear`` (the JAX
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


def check_offsets(values_shape, out_hw) -> None:
    """Raise where an image's element offsets would not fit 32 bits."""
    _, hs, ws, c = (int(v) for v in values_shape)
    out_h, out_w = (int(v) for v in out_hw)
    if max(hs * ws * max(c, 2), out_h * out_w * (c + 1)) >= 2**31:
        raise ValueError("an image's offsets must fit 32 bits")


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
    check_offsets(values_shape, out_hw)
    n, hs, ws, c = (int(v) for v in values_shape)
    block_y = THREADS // block_x
    tile_h = block_y * rows_per_thread
    return check_tiling(Tiling(
        block=(block_x, block_y), tile=(tile_h, block_x),
        grid=(-(-ws // block_x), -(-hs // tile_h), n),
        smem_bytes=smem_bytes, vec4=c == 4 and aligned16))


#: The band kernel's blocks an SM holds (``kBlocksPerSM`` in
#: splat_band.cu): each block's band gets a quarter of the SM's 228 KB of
#: shared memory, less the 1 KB the card keeps per block.
BAND_BLOCKS_PER_SM = 4
BAND_SMEM_BYTES = 233_472 // BAND_BLOCKS_PER_SM - 1024
#: Streaming multiprocessors of an H100 SXM.
SMS = 132
#: What a visited row of a layer that lands in the band costs a block,
#: per plane, against what a visited row costs that it only reads and
#: culls: a live pixel adds its corners to every plane with shared-memory
#: atomics; a culled one reads its coordinates and tests them.
BAND_LIVE_COST = 0.75


@dataclasses.dataclass(frozen=True)
class BandTiling:
    """The band kernel's launch: blocks of 512 threads (``kThreads`` in
    splat_band.cu), each owning ``rows`` target rows of one image at full
    width, ``grid``
    (bands, N, 1); the band's planes ``plane_stride`` floats apart in
    shared memory, ``smem_bytes`` in all; ``vec4`` float4 value loads."""
    rows: int
    grid: tuple
    plane_stride: int
    smem_bytes: int
    vec4: bool


def band_plane_stride(rows: int, out_w: int, channels: int) -> int:
    """Floats between the band's planes: ``rows * out_w``, padded so that
    consecutive planes start ``ceil(32 / C)`` banks apart, which spreads
    the pixel-major reads of the band's store over the 32 banks."""
    px = rows * out_w
    return px + (-(-32 // channels) - px) % 32


def band_source_rows(t0: int, rows: int, window, layers: int):
    """The source rows the band of target rows ``[t0, t0 + rows)`` visits:
    in each folded layer ``l``, ``l * fold_h + b`` for ``b`` in
    ``[t0 - max_dy - 1 - base_offset, t0 + rows - 1 + max_dy -
    base_offset]`` clipped to ``[0, fold_h)`` (``band_of_block`` in
    ``csrc/splat_band.cu``): exactly the rows whose window reaches it."""
    max_dy, fold_h, base_offset = window
    lo = max(0, t0 - max_dy - 1 - base_offset)
    hi = min(fold_h - 1, t0 + rows - 1 + max_dy - base_offset)
    return [l * fold_h + b for l in range(layers) for b in range(lo, hi + 1)]


def band_tiling(values_shape, out_hw, window, *, weights: bool = True,
                aligned16: bool = False, rows=None) -> BandTiling:
    """The band kernel's launch for values (N, Hs, Ws, C) splatted into
    ``out_hw`` under ``window`` ((max_dy, fold_h, base_offset), checked).

    A block's band (C planes and, with ``weights``, one of wsum) must fit
    ``BAND_SMEM_BYTES``, or ValueError (as the TPU kernel's VMEM check).
    Of the band heights that fit, the plan takes the one that minimises
    the busiest SM's work: ``ceil(blocks / (SMS * BAND_BLOCKS_PER_SM))``
    blocks, each visiting ``min(fold_h, rows + 2 max_dy + 1)`` rows of
    every layer and adding ``rows`` of them, at ``BAND_LIVE_COST`` per
    plane, into the band. ``rows`` forces the band height (it must fit).
    ``aligned16``: values start on a 16-byte boundary, which at C = 4
    takes float4 loads.
    """
    check_offsets(values_shape, out_hw)
    n, hs, ws, c = (int(v) for v in values_shape)
    out_h, out_w = (int(v) for v in out_hw)
    max_dy, fold_h, base_offset = window
    if max_dy < 0:
        raise ValueError("the band kernel is the windowed splat: max_dy >= 0")
    layers = hs // fold_h
    planes = c + bool(weights)
    best = None
    for height in (range(1, out_h + 1) if rows is None else (rows,)):
        stride = band_plane_stride(height, out_w, c)
        smem = planes * stride * 4
        if smem > BAND_SMEM_BYTES:
            break
        blocks = -(-out_h // height) * n
        work = layers * (min(fold_h, height + 2 * max_dy + 1)
                         + height * planes * BAND_LIVE_COST)
        cost = -(-blocks // (SMS * BAND_BLOCKS_PER_SM)) * work
        if best is None or cost < best[0]:
            best = (cost, height, stride, smem)
    if best is None:
        raise ValueError(
            f"a band of {rows or 1} target row(s) of {out_w} px x {planes} "
            f"planes does not fit the {BAND_SMEM_BYTES} B of shared memory "
            "a band kernel block may use")
    _, height, stride, smem = best
    return check_band_tiling(BandTiling(
        rows=height, grid=(-(-out_h // height), n, 1), plane_stride=stride,
        smem_bytes=smem, vec4=c == 4 and aligned16))


#: The band kernel takes a windowed splat when its plan's blocks read at
#: most this many coordinate rows of a layer for each target row they own.
BAND_MAX_READS = 4


def use_band(tiling: BandTiling, window) -> bool:
    """Which kernel a windowed splat takes: the band kernel when a band of
    ``tiling.rows`` rows visits at most ``BAND_MAX_READS`` rows of each
    layer a band row (``rows + 2 max_dy + 1``) and the plan has a block
    for every slot of the card (``SMS * BAND_BLOCKS_PER_SM``), else the
    box kernel. Measured on an NVIDIA H100 80GB HBM3 at 700 W, the kernel
    alone (torch.profiler; scripts/compare_parent_kernels.py, PERF.md §6),
    band against box: the route MPI step's planes' gradient (1.5
    rows a row, 1536 blocks) 74.9 us against 105.9, the route's b8
    serving render (3.5, 1024 blocks) 88.2 against 103.2; a height shard
    (3.5, 288 blocks) 61.9 against 42.5, the route quality step's full
    LDI (9.5) 233.8 against 178.2, the sweep's chunk (17.5) 199.5 against
    135.7."""
    rows, max_dy = tiling.rows, window[0]
    return (rows + 2 * max_dy + 1 <= BAND_MAX_READS * rows
            and tiling.grid[0] * tiling.grid[1] >= SMS * BAND_BLOCKS_PER_SM)


def band_plan(values: torch.Tensor, out_hw, window, weights):
    """The band kernel's plan for a windowed splat of ``values`` where
    :func:`use_band` takes it, else None (the box kernel)."""
    plan = band_tiling(values.shape, out_hw, window,
                       weights=weights is not None,
                       aligned16=values.data_ptr() % 16 == 0)
    return plan if use_band(plan, window) else None


def check_band_tiling(t: BandTiling) -> BandTiling:
    """Raise where ``t`` breaks CUDA's limits; return it."""
    if not 0 <= t.smem_bytes <= MAX_SMEM_BYTES:
        raise ValueError(f"{t.smem_bytes} B of shared memory")
    if any(not 1 <= g <= m for g, m in zip(t.grid, MAX_GRID)):
        raise ValueError(f"grid {t.grid} beyond CUDA's limits {MAX_GRID}")
    return t


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


def _check(values: torch.Tensor, coords: torch.Tensor, weights, out_hw
           ) -> None:
    if values.ndim != 4:
        raise ValueError(f"values must be (N, Hs, Ws, C), got {tuple(values.shape)}")
    n, hs, ws, c = values.shape
    tensors = {"values": values, "coords": coords, "weights": weights}
    want = {"coords": (n, hs, ws, 2), "weights": (n, hs, ws, 1)}
    for name in want:
        t = tensors[name]
        if t is None and name == "weights":
            del tensors[name]
        elif tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(t.shape)}")
    check_tensors(tensors, values.device)
    if not 1 <= c <= 8:
        raise ValueError(f"the kernel takes 1..8 channels, got {c}")
    out_h, out_w = out_hw
    if out_h <= 0 or out_w <= 0:
        raise ValueError(f"out_hw must be positive, got {out_hw}")


def splat(values: torch.Tensor, coords: torch.Tensor, weights, out_hw,
          snap: bool = True, max_dy: int = -1, fold_h=None,
          base_offset: int = 0, deterministic: bool = False):
    """Forward-splat ``values`` into an ``out_hw`` image (K1, or K1-D).

    Args:
      values:  (N, Hs, Ws, C) float32, C in 1..8; layers may be folded into
        Hs, the targets come from ``coords`` alone.
      coords:  (N, Hs, Ws, 2) float32 target pixel [x, y].
      weights: (N, Hs, Ws, 1) float32, or None: the values splatted
        unweighted, and no wsum (the gather's image gradient).
      out_hw:  (out_h, out_w).
      snap: snap the bilinear fractions (the render); False gives the
        transpose of the unsnapped gather (``GatherFn``'s image gradient).
      max_dy, fold_h, base_offset: with ``max_dy >= 0``, drop every corner
        whose row lies outside ``[base - max_dy, base + max_dy + 1]``,
        ``base = r % fold_h + base_offset`` for source row r
        (:func:`window_base_rows`); -1 (the default) is no window.
      deterministic: the sort splat (``render.splat_method="sort"``):
        K1-D on the card, ``splat_bilinear(method="sort")`` on the CPU;
        the same function, summed in one fixed order, so two calls are
        bitwise equal.
    Returns:
      accum (N, out_h, out_w, C) and wsum (N, out_h, out_w, 1), float32
      (wsum None without weights).
    """
    _check(values, coords, weights, out_hw)
    check_no_grad("splat", *(t for t in (values, coords, weights)
                             if t is not None))
    window = check_window(values.shape[1], int(out_hw[0]), max_dy, fold_h,
                          base_offset)
    if deterministic:
        check_sort_sizes(values.shape, out_hw)
    if not check_device(values.device):
        return splat_bilinear(
            values, coords, weights, out_hw, snap=snap,
            max_dy_window=None if window[0] < 0 else window[0],
            base_rows=window_base_rows(values.shape[1], int(out_hw[0]),
                                       *window),
            method="sort" if deterministic else "scatter")
    if deterministic:
        return _launch_sort(values, coords, weights, out_hw, snap, window)
    return _launch_splat(values, coords, weights, out_hw, snap,
                         window=window)


def check_sort_sizes(values_shape, out_hw) -> None:
    """Raise ValueError where K1-D's int32 positions and targets cannot
    hold the splat: the 4 N Hs Ws corner positions must stay below 2^31
    and the N out_h out_w targets below INT_MAX."""
    n, hs, ws, _ = (int(v) for v in values_shape)
    out_h, out_w = (int(v) for v in out_hw)
    if 4 * n * hs * ws >= 2**31 or n * out_h * out_w >= 2**31 - 1:
        raise ValueError(
            f"the deterministic splat's int32 positions cannot hold "
            f"{4 * n * hs * ws} corners into {n * out_h * out_w} target "
            "pixels")


#: The longest run of a target that one thread of K1-D's sum kernel sorts
#: and adds (``kShortRun`` in splat_sort.cu); a longer run takes a warp.
SORT_SHORT_RUN = 32
#: Positions a warp of K1-D's long-run kernel sorts in shared memory
#: (``kLongRun``); a longer run is sorted in place in global memory.
SORT_LONG_RUN = 512
#: Targets one block of K1-D's scan covers (``kScanTile``).
SORT_SCAN_TILE = 16 * THREADS
#: Blocks of the long-run kernel an SM holds: 8 warps of 16 KB of shared
#: memory each.
SORT_LONG_BLOCKS_PER_SM = 8


@dataclasses.dataclass(frozen=True)
class SortPlan:
    """K1-D's launch (``lsi_splat_sort``): ``targets`` pixels,
    ``corners`` positions, ``tiles`` blocks of the scan; the long-run list
    holds ``long_capacity`` targets (every run longer than
    ``SORT_SHORT_RUN`` has a place), walked by ``long_blocks`` blocks (0:
    no run can be long, no launch); ``scratch_ints`` int32 of scratch:
    the cursors and the long-run count, the tile sums, the positions and
    the list."""
    targets: int
    corners: int
    tiles: int
    long_capacity: int
    long_blocks: int
    scratch_ints: int


def sort_plan(values_shape, out_hw) -> SortPlan:
    """K1-D's plan for values (N, Hs, Ws, C) splatted into ``out_hw``
    (sizes checked by :func:`check_sort_sizes`)."""
    check_sort_sizes(values_shape, out_hw)
    n, hs, ws, _ = (int(v) for v in values_shape)
    out_h, out_w = (int(v) for v in out_hw)
    targets = n * out_h * out_w
    corners = 4 * n * hs * ws
    tiles = -(-targets // SORT_SCAN_TILE)
    long_capacity = min(targets, corners // (SORT_SHORT_RUN + 1))
    long_blocks = min(SMS * SORT_LONG_BLOCKS_PER_SM,
                      -(-long_capacity // (THREADS // 32)))
    return SortPlan(targets=targets, corners=corners, tiles=tiles,
                    long_capacity=long_capacity, long_blocks=long_blocks,
                    scratch_ints=targets + 1 + tiles + corners
                    + long_capacity)


def _launch_sort(values, coords, weights, out_hw, snap, window):
    """K1-D on CUDA tensors (``csrc/splat_sort.cu``, one call of
    ``lsi_splat_sort``: a memset of the counts, then the count, scan,
    fill, sum and long-run kernels); counts one launch."""
    n, hs, ws, c = values.shape
    out_h, out_w = (int(v) for v in out_hw)
    plan = sort_plan(values.shape, out_hw)
    coords = aligned(coords, 8)  # read as float2
    dev = values.device
    scratch = torch.empty(plan.scratch_ints, dtype=torch.int32, device=dev)
    # Every output pixel is written.
    accum = torch.empty((n, out_h, out_w, c), dtype=torch.float32,
                        device=dev)
    wsum = None if weights is None else torch.empty(
        (n, out_h, out_w, 1), dtype=torch.float32, device=dev)
    build.launch("splat_sort", "lsi_splat_sort", dev, values.data_ptr(),
                 coords.data_ptr(), _ptr(weights), accum.data_ptr(),
                 _ptr(wsum), scratch.data_ptr(), n, hs, ws, c, out_h, out_w,
                 int(snap), *window, plan.long_capacity, plan.long_blocks)
    splat.sort_launches += 1
    return accum, wsum


def _launch_splat(values, coords, weights, out_hw, snap, tiling=None,
                  window=(-1, 1, 0)):
    """Launch K1 on CUDA tensors and count the launch, with ``window``
    ((max_dy, fold_h, base_offset), checked by the caller): the band
    kernel as ``tiling`` (a :class:`BandTiling`) says, or the box kernel
    as ``tiling`` (a :class:`Tiling`) says; without ``tiling``, a windowed
    splat's :func:`band_plan` where :func:`use_band` takes it, else the
    box kernel's (:func:`splat_tiling`)."""
    n, hs, ws, c = values.shape
    out_h, out_w = (int(v) for v in out_hw)
    if tiling is None and window[0] >= 0:
        tiling = band_plan(values, out_hw, window, weights)
    band = isinstance(tiling, BandTiling)
    coords = aligned(coords, 8)  # read as float2
    # The band kernel writes every output pixel; the box kernel adds.
    alloc = torch.empty if band else torch.zeros
    accum = alloc((n, out_h, out_w, c), dtype=torch.float32,
                  device=values.device)
    wsum = None if weights is None else alloc(
        (n, out_h, out_w, 1), dtype=torch.float32, device=values.device)
    if band:
        build.launch("splat_fwd", "lsi_splat_band", values.device,
                     values.data_ptr(), coords.data_ptr(), _ptr(weights),
                     accum.data_ptr(), _ptr(wsum), n, hs, ws, c, out_h,
                     out_w, int(snap), *window, tiling.rows,
                     tiling.plane_stride, tiling.smem_bytes,
                     int(tiling.vec4))
        splat.band_launches += 1
    else:
        if tiling is None:
            tiling = splat_tiling(values.shape, out_hw, aligned16=all(
                t.data_ptr() % 16 == 0 for t in (values, accum)))
        build.launch("splat_fwd", "lsi_splat_fwd", values.device,
                     values.data_ptr(), coords.data_ptr(), _ptr(weights),
                     accum.data_ptr(), _ptr(wsum), n, hs, ws, c, out_h,
                     out_w, int(snap), tiling.block[0], tiling.tile[0],
                     tiling.smem_bytes, int(tiling.vec4), *window)
    splat.launches += 1
    splat.window_launches += window[0] >= 0
    return accum, wsum


def _ptr(t) -> int:
    """A tensor's data pointer, 0 (null) for None."""
    return 0 if t is None else t.data_ptr()


#: K1 launches made through :func:`splat` (CPU calls do not count), how
#: many of them were windowed, and how many of those took the band kernel;
#: and K1-D launches (``deterministic=True``), windowed or not.
splat.launches = 0
splat.window_launches = 0
splat.band_launches = 0
splat.sort_launches = 0


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
    """Differentiable splat: K1 (or K1-D) forward, K2 + K3 backward.

    ``SplatFn.apply(values, coords, weights, out_hw) -> (accum, wsum)``;
    ``SplatFn.apply(values, coords, weights, out_hw, max_dy, fold_h,
    base_offset)`` is the windowed splat (:func:`splat`), whose gradients
    are the window's too; a last argument ``deterministic=True`` takes
    K1-D forward (``render.splat_method="sort"``). The backward is
    ``lsi_splat_vjp`` either way: the gradient of JAX's sort path is the
    scatter path's, and K2 adds no atomics. It computes only the
    gradients autograd asks for.
    """

    @staticmethod
    def forward(ctx, values, coords, weights, out_hw, max_dy=-1, fold_h=None,
                base_offset=0, deterministic=False):
        ctx.out_hw = tuple(int(v) for v in out_hw)
        ctx.window = dict(max_dy=max_dy, fold_h=fold_h,
                          base_offset=base_offset)
        ctx.save_for_backward(values, coords, weights)
        return splat(values, coords, weights, ctx.out_hw, **ctx.window,
                     deterministic=deterministic)

    @staticmethod
    def backward(ctx, g_accum, g_wsum):
        needs = ctx.needs_input_grad[:3]
        if not any(needs):
            return (None,) * 8
        values, coords, weights = ctx.saved_tensors
        d_values, d_coords, d_weights = splat_vjp(
            values, coords, weights, g_accum.float().contiguous(),
            g_wsum.float().contiguous(), ctx.out_hw, needs, **ctx.window)
        return (d_values, d_coords, d_weights) + (None,) * 5
