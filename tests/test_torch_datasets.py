"""The KITTI and SYNTHIA readers against the JAX package's, on directories
in the published layouts (``lsi_tpu_torch.data.layouts``: synthetic scenes
as the content, Velodyne scans back-projected from the scenes' depth).

Each stream is compared twice, once with both packages decoding through
their native loader and once with both through PIL (the two resize
differently, so like is compared with like): the examples are bitwise
equal, and so are the batches ``decode_batch`` makes of them.
"""

import dataclasses
import os

import numpy as np
import pytest

from lsi_tpu.config import DataConfig as JDataConfig
from lsi_tpu.data import kitti as jkitti
from lsi_tpu.data import kitti_velodyne as jvelo
from lsi_tpu.data import pipeline as jpipe
from lsi_tpu.data import synthia as jsynthia
from lsi_tpu_torch import native as tnative
from lsi_tpu_torch.config import DataConfig
from lsi_tpu_torch.data import kitti as tkitti
from lsi_tpu_torch.data import kitti_velodyne as tvelo
from lsi_tpu_torch.data import layouts
from lsi_tpu_torch.data import pipeline as tpipe
from lsi_tpu_torch.data import synthia as tsynthia

KITTI_HW, SYNTHIA_HW = (40, 132), (38, 64)
OUT_H, OUT_W = 32, 96


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    from lsi_tpu import native
    if native._LIB is None and not native._TRIED:
        # A private build directory: another test process may be writing
        # the JAX package's library into its shared default one right now.
        native._CACHE_DIR = str(tmp_path_factory.mktemp("jax_native"))
    d = tmp_path_factory.mktemp("layouts")
    layouts.write_kitti_raw(str(d / "kitti"), drives=2, frames=3,
                            hw=KITTI_HW, seed=1)
    layouts.write_synthia_seqs(str(d / "synthia"), frames=3, hw=SYNTHIA_HW,
                               seed=2)
    return {"kitti": str(d / "kitti"), "synthia": str(d / "synthia")}


@pytest.fixture(params=["native", "pil"])
def decoder(request, monkeypatch):
    """Both packages decode with the native loader, or both with PIL."""
    from lsi_tpu import native as jnative
    if request.param == "pil":
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(tnative, "available", lambda: False)
    elif not (jnative.available() and tnative.available()):
        pytest.skip("native loader toolchain unavailable")
    tkitti.DECODED.clear()
    tsynthia.DECODED.clear()
    return request.param


def configs(root, dataset, **kw):
    kw = dict(dataset=dataset, root=root, height=OUT_H, width=OUT_W,
              batch_size=2, **kw)
    return JDataConfig(**kw), DataConfig(**kw)


def assert_examples_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def assert_batches_equal(tcfg, jcfg, seed, n):
    """``n`` batches of the port's prefetched stream against JAX's, raw and
    decoded."""
    ref = jpipe._batch_stream(jcfg, seed, True)
    it = tpipe.make_dataset(tcfg, seed=seed, device="cpu")
    try:
        for _ in range(n):
            want = next(ref)
            got = next(it)
            dec, jdec = tpipe.decode_batch(got), jpipe.decode_batch(want)
            for f in dataclasses.fields(tpipe.Batch):
                w, g = getattr(want, f.name), getattr(got, f.name)
                if w is None:
                    assert g is None, f.name
                    continue
                np.testing.assert_array_equal(g.numpy(), w, err_msg=f.name)
                np.testing.assert_array_equal(
                    getattr(dec, f.name).numpy(),
                    np.asarray(getattr(jdec, f.name)), err_msg=f.name)
    finally:
        it.close()


@pytest.mark.parametrize("augment", [False, True])
def test_kitti_stereo_stream_matches_jax(roots, decoder, augment):
    jcfg, tcfg = configs(roots["kitti"], "kitti", augment=augment)
    want = list(jkitti.example_stream(jcfg, 3, False))
    got = list(tkitti.example_stream(tcfg, 3, False))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert_examples_equal(g, w)
    assert dict(tkitti.DECODED) == {decoder: 12}
    # LiDAR ground truth on the unswapped frames that have a scan.
    assert any(g["gt_valid"].sum() > 0 for g in got)
    assert_batches_equal(tcfg, jcfg, 3, 4)


@pytest.mark.parametrize("split", ["train", "val"])
def test_kitti_temporal_stream_matches_jax(roots, decoder, split):
    jcfg, tcfg = configs(roots["kitti"], "kitti", kitti_pairs="temporal",
                         split=split)
    want = list(jkitti.example_stream(jcfg, 0, False))
    got = list(tkitti.example_stream(tcfg, 0, False))
    assert len(got) == len(want) == 2  # one held-out drive each way
    for g, w in zip(got, want):
        assert_examples_equal(g, w)
    assert abs(got[0]["pose_src2trg"][:3, 3]).max() > 0.5  # ~1 m a frame


def test_kitti_velodyne_matches_jax(roots):
    """The scan of frame 0 of drive 1 rasterized at two sizes: the same
    sparse disparity, and the scene's own disparity where it is valid."""
    from lsi_tpu_torch.data import synthetic
    image = os.path.join(roots["kitti"], layouts.KITTI_DATE,
                         f"{layouts.KITTI_DATE}_drive_0001_sync", "image_02",
                         "data", "0000000000.png")
    calib = os.path.join(roots["kitti"], layouts.KITTI_DATE,
                         "calib_cam_to_cam.txt")
    for out_hw in (KITTI_HW, (OUT_H, OUT_W)):
        got = tvelo.VelodyneDepth().disparity_for(image, calib, KITTI_HW,
                                                  out_hw)
        want = jvelo.VelodyneDepth().disparity_for(image, calib, KITTI_HW,
                                                   out_hw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    disp, valid = tvelo.VelodyneDepth().disparity_for(image, calib, KITTI_HW,
                                                      KITTI_HW)
    scene = synthetic.scene_example("multi", 1, 0, 0, *KITTI_HW)
    m = valid[..., 0] > 0
    assert m.sum() > 500
    np.testing.assert_allclose(disp[..., 0][m],
                               scene["gt_disparity"][..., 0][m], rtol=1e-5)
    assert tvelo.velodyne_path_for_image(image.replace("0000000000",
                                                       "0000000001")) == ""


def test_kitti_intrinsics_scaling_matches_jax():
    from lsi_tpu.geometry.projection import scale_intrinsics
    K = np.array([[[721.5377, 0, 609.5593], [0, 721.5377, 172.854],
                   [0, 0, 1]]], np.float32)
    for sx, sy in ((768 / 1242, 256 / 375), (1.0, 1.0), (0.5, 0.5),
                   (1280 / 1242, 3.3)):
        np.testing.assert_array_equal(tkitti.scale_intrinsics(K, sx, sy),
                                      np.asarray(scale_intrinsics(K, sx, sy)))


@pytest.mark.parametrize("augment", [False, True])
def test_synthia_stream_matches_jax(roots, decoder, augment):
    jcfg, tcfg = configs(roots["synthia"], "synthia", augment=augment)
    want = list(jsynthia.example_stream(jcfg, 4, False))
    got = list(tsynthia.example_stream(tcfg, 4, False))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_examples_equal(g, w)
        assert g["gt_valid"].min() == 1.0 and g["trg_gt_valid"].min() == 1.0
    assert dict(tsynthia.DECODED) == {decoder: 6,
                                      f"{decoder}_depth16": 6}
    assert_batches_equal(tcfg, jcfg, 4, 2)


def test_missing_roots_raise_as_jax():
    for dataset, pairs in (("kitti", "stereo"), ("kitti", "temporal"),
                           ("synthia", "stereo")):
        jcfg, tcfg = configs("/nonexistent", dataset, kitti_pairs=pairs)
        mod_j, mod_t = ((jkitti, tkitti) if dataset == "kitti"
                        else (jsynthia, tsynthia))
        with pytest.raises(FileNotFoundError):
            next(mod_j.example_stream(jcfg, 0, False))
        with pytest.raises(FileNotFoundError, match="no (KITTI|SYNTHIA)"):
            next(mod_t.example_stream(tcfg, 0, False))


def test_layouts_cli_drives(tmp_path):
    """The layouts CLI writes the KITTI drives asked for; the SYNTHIA
    layout, one sequence, refuses --drives and writes nothing."""
    layouts.main(["kitti", "--out", str(tmp_path / "k"), "--frames", "1",
                  "--drives", "2", "--workers", "0"])
    date = tmp_path / "k" / layouts.KITTI_DATE
    assert sorted(p.name for p in date.glob("*_sync")) == [
        f"{layouts.KITTI_DATE}_drive_{d:04d}_sync" for d in (1, 2)]
    with pytest.raises(SystemExit) as e:
        layouts.main(["synthia", "--out", str(tmp_path / "s"), "--drives",
                      "2", "--workers", "0"])
    assert e.value.code == 2 and not (tmp_path / "s").exists()
