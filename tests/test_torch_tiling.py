"""The launch choices of the tiled kernels, K1 (``splat_tiling``; its
windowed mode, the band kernel: ``band_tiling``) and the gather's forward
(``gather_tiling``), at every shape that ``chip_smoke.py`` and the tests
give them, plus ragged sizes: each source pixel in exactly one tile (each
target row in exactly one band, whose visited source rows are exactly
those whose window reaches it), shared memory and grid within CUDA's
limits, the float4 path only at C = 4 with aligned pointers.

The kernels themselves run only on a CUDA card: tests/test_torch_cuda.py.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads per process)
import numpy as np
import pytest
import torch

from lsi_tpu_torch.kernels import gather_cuda, splat_cuda

# values (N, Hs, Ws, C) -> out_hw
SPLAT_SHAPES = [
    ((8, 512, 768, 4), (256, 768)),    # kitti_ldi2 render, b8
    ((16, 512, 768, 4), (256, 768)),   # kitti_ldi2 render, b16
    ((16, 768, 768, 4), (256, 768)),   # kitti_ldi3_b16 train step
    ((16, 768, 768, 3), (256, 768)),   # the gather's d_image (unsnapped)
    ((2, 64, 64, 4), (32, 64)),        # golden fixtures, 2x32x64
    ((2, 32, 128, 1), (16, 128)),      # tests/test_torch_cuda.py
    ((2, 32, 128, 8), (16, 128)),
    ((1, 16, 128, 4), (16, 128)),
    ((2, 13, 77, 5), (13, 77)),        # ragged
    ((3, 13, 77, 4), (7, 300)),
    ((1, 1, 1, 2), (1, 1)),
]
# values (N, Hs, Ws, C) -> out_hw, window (max_dy, fold_h, base_offset),
# with weights (K1 of the render) or without (the gather's image gradient)
BAND_SHAPES = [
    ((8, 768, 768, 4), (256, 768), (8, 256, 0), True),    # route step
    ((8, 128, 768, 4), (72, 768), (2, 64, 4), True),      # height shard 1
    ((8, 128, 768, 4), (68, 768), (2, 64, 0), True),      # height shard 0
    ((8, 512, 768, 4), (256, 768), (16, 256, 0), True),   # the sweep
    ((8, 512, 768, 4), (256, 768), (2, 256, 0), True),    # serving, route
    ((128, 128, 256, 4), (128, 256), (2, 128, 0), False),  # MPI d_image
    ((8, 768, 768, 3), (256, 768), (8, 256, 0), False),   # K4-W d_image
    ((64, 1024, 1536, 4), (512, 1536), (2, 512, 0), True),  # widest rows
    ((2, 32, 128, 4), (24, 128), (1, 16, 4), True),       # the gpu tests
    ((2, 39, 130, 5), (13, 130), (16, 13, 0), False),
    ((2, 40, 77, 8), (50, 77), (0, 40, 5), True),         # ragged
    ((3, 13, 7, 1), (20, 7), (1, 13, 7), True),
    ((1, 1, 1, 2), (1, 1), (0, 1, 0), False),
]
# image (N, Hi, Wi, C), coords (N, Hs, Ws, 2)
GATHER_SHAPES = [
    ((16, 256, 768, 3), (16, 768, 768, 2)),  # chip_smoke, the b16 step
    ((8, 256, 768, 3), (8, 768, 768, 2)),    # the b8 step
    ((2, 32, 64, 3), (2, 96, 64, 2)),        # golden train fixture
    ((2, 16, 128, 8), (2, 48, 128, 2)),      # tests/test_torch_cuda.py
    ((1, 16, 128, 3), (1, 32, 128, 2)),
    ((2, 12, 20, 3), (2, 9, 20, 2)),         # tests/test_torch_gather.py
    ((2, 13, 77, 4), (2, 13, 77, 2)),        # ragged
    ((2, 13, 77, 1), (2, 65, 77, 2)),        # 5 folded layers: > 4
    ((1, 5, 9, 2), (1, 1, 300, 2)),
]


def check_limits(t):
    assert t.block[0] * t.block[1] == splat_cuda.THREADS
    assert 0 <= t.smem_bytes <= 232_448
    assert 1 <= t.grid[0] <= 2**31 - 1
    assert 1 <= t.grid[1] <= 65_535 and 1 <= t.grid[2] <= 65_535


@pytest.mark.parametrize("values_shape,out_hw", SPLAT_SHAPES)
def test_splat_tiling_covers_each_pixel_once(values_shape, out_hw):
    n, hs, ws, c = values_shape
    t = splat_cuda.splat_tiling(values_shape, out_hw, aligned16=True)
    check_limits(t)
    assert t.grid[2] == n
    tile_h, tile_w = t.tile
    assert tile_w == t.block[0] and tile_h % t.block[1] == 0
    hits = np.zeros((hs, ws), np.int64)
    for gy in range(t.grid[1]):
        for gx in range(t.grid[0]):
            hits[gy * tile_h:(gy + 1) * tile_h,
                 gx * tile_w:(gx + 1) * tile_w] += 1
    assert (hits == 1).all()
    # No block is wholly outside the image.
    assert (t.grid[0] - 1) * tile_w < ws and (t.grid[1] - 1) * tile_h < hs


@pytest.mark.parametrize("values_shape,out_hw,window,weights", BAND_SHAPES)
def test_band_tiling_covers_each_row_once(values_shape, out_hw, window,
                                          weights):
    n, hs, ws, c = values_shape
    out_h, out_w = out_hw
    max_dy, fold_h, base_offset = window
    t = splat_cuda.band_tiling(values_shape, out_hw, window,
                               weights=weights)
    planes = c + weights
    assert 0 < t.smem_bytes <= splat_cuda.BAND_SMEM_BYTES
    assert splat_cuda.BAND_BLOCKS_PER_SM * (splat_cuda.BAND_SMEM_BYTES
                                            + 1024) <= 233_472
    assert 1 <= t.grid[0] <= 2**31 - 1 and t.grid[1] == n <= 65_535
    assert t.plane_stride >= t.rows * out_w
    assert t.smem_bytes == planes * t.plane_stride * 4
    hits = np.zeros(out_h, np.int64)
    layers = hs // fold_h
    for band in range(t.grid[0]):
        t0 = band * t.rows
        rows = min(t.rows, out_h - t0)
        assert rows > 0
        hits[t0:t0 + rows] += 1
        # Source row r reaches the band when some band row lies within
        # [base - max_dy, base + max_dy + 1], base = r % fold_h + offset.
        reach = [r for r in range(hs) if any(
            abs(y - (r % fold_h + base_offset) - 0.5) <= max_dy + 0.5
            for y in range(t0, t0 + rows))]
        assert splat_cuda.band_source_rows(t0, rows, window,
                                           layers) == reach
    assert (hits == 1).all()


@pytest.mark.parametrize("values_shape,out_hw,window,weights,band", [
    ((128, 128, 256, 4), (128, 256), (2, 128, 0), False, True),  # MPI
    ((8, 512, 768, 4), (256, 768), (2, 256, 0), True, True),  # serving
    ((8, 128, 768, 4), (72, 768), (2, 64, 4), True, False),   # shard
    ((8, 768, 768, 4), (256, 768), (8, 256, 0), True, False),  # quality
    ((8, 512, 768, 4), (256, 768), (16, 256, 0), True, False),  # sweep
], ids=["mpi", "serving", "shard", "quality", "sweep"])
def test_band_rule_follows_the_measurements(values_shape, out_hw, window,
                                            weights, band):
    """use_band takes the band kernel on the route's main-path inputs
    where it was measured faster than the box kernel, and only there."""
    t = splat_cuda.band_tiling(values_shape, out_hw, window,
                               weights=weights)
    assert splat_cuda.use_band(t, window) == band


def test_band_tiling_refuses_what_cuda_cannot_launch():
    with pytest.raises(ValueError, match="does not fit"):
        splat_cuda.band_tiling((1, 4, 8000, 8), (4, 8000), (2, 4, 0))
    # One row fits, two do not.
    assert splat_cuda.band_tiling((1, 4, 1500, 8), (4, 1500),
                                  (2, 4, 0)).rows == 1
    with pytest.raises(ValueError, match="does not fit"):
        splat_cuda.band_tiling((1, 4, 1500, 8), (4, 1500), (2, 4, 0),
                               rows=2)
    with pytest.raises(ValueError, match="grid"):
        splat_cuda.band_tiling((70_000, 4, 64, 4), (4, 64), (2, 4, 0))
    with pytest.raises(ValueError, match="max_dy"):
        splat_cuda.band_tiling((1, 4, 64, 4), (4, 64), (-1, 1, 0))
    with pytest.raises(ValueError, match="32 bits"):
        splat_cuda.band_tiling((1, 4, 64, 4), (40_000, 40_000), (2, 4, 0))


@pytest.mark.parametrize("image_shape,coords_shape", GATHER_SHAPES)
def test_gather_tiling_covers_each_pixel_once(image_shape, coords_shape):
    n, hi, _, c = image_shape
    _, hs, ws, _ = coords_shape
    t = gather_cuda.gather_tiling(image_shape, coords_shape)
    check_limits(t)
    assert t.grid[2] == n
    rows = np.zeros(hs, np.int64)
    for g in range(t.grid[1]):
        tile = gather_cuda.gather_tile_rows(t, g, hs)
        assert tile == sorted(tile) and len(tile) <= t.tile[0]
        rows[tile] += 1
    assert (rows == 1).all()
    assert t.grid[0] * t.tile[1] >= ws > (t.grid[0] - 1) * t.tile[1]
    if hs % hi == 0 and 1 < hs // hi <= 4:
        # Folded layers: a tile holds one row of each layer.
        assert t.row_stride == hi and t.tile[0] == hs // hi
        for g in range(t.grid[1]):
            assert len({r % hi for r in gather_cuda.gather_tile_rows(
                t, g, hs)}) == 1


@pytest.mark.parametrize("c", range(1, 9))
@pytest.mark.parametrize("aligned16", [True, False])
def test_splat_float4_path_only_at_c4_aligned(c, aligned16):
    t = splat_cuda.splat_tiling((2, 32, 128, c), (16, 128),
                                aligned16=aligned16)
    assert t.vec4 == (c == 4 and aligned16)
    t = splat_cuda.band_tiling((2, 32, 128, c), (16, 128), (1, 16, 0),
                               aligned16=aligned16)
    assert t.vec4 == (c == 4 and aligned16)


def test_tilings_refuse_what_cuda_cannot_launch():
    with pytest.raises(ValueError, match="grid"):
        splat_cuda.splat_tiling((70_000, 4, 64, 4), (4, 64), aligned16=True)
    with pytest.raises(ValueError, match="shared memory"):
        splat_cuda.splat_tiling((1, 4, 64, 4), (4, 64), aligned16=True,
                                smem_bytes=240_000)
    with pytest.raises(ValueError, match="32 bits"):
        splat_cuda.splat_tiling((1, 4, 64, 4), (40_000, 40_000),
                                aligned16=True)
    with pytest.raises(ValueError, match="32 bits"):
        gather_cuda.gather_tiling((1, 40_000, 40_000, 3), (1, 4, 64, 2))


def test_misaligned_views_are_copied_before_vector_loads():
    base = torch.arange(2 * 4 * 6 * 2 + 1, dtype=torch.float32)
    view = base[1:].view(2, 4, 6, 2)  # starts 4 bytes into the storage
    assert view.data_ptr() % 8 == 4
    copy = splat_cuda.aligned(view, 8)
    assert copy.data_ptr() % 8 == 0 and torch.equal(copy, view)
    whole = base[:96].view(2, 4, 6, 2)
    assert splat_cuda.aligned(whole, 8) is whole


def test_gather_tiling_takes_at_most_four_rows_a_block():
    with pytest.raises(ValueError, match="max_tile_rows"):
        gather_cuda.gather_tiling((1, 8, 64, 3), (1, 40, 64, 2),
                                  max_tile_rows=5)
