"""The port's native image loader (``lsi_tpu_torch.native``) against the JAX
package's (``lsi_tpu.native``): the same files, good, corrupt and missing,
give bitwise the same arrays (both are built from the same C++ source with
the same flags; the port's into ``lsi_tpu_torch/_build/``)."""

import torch_threads  # noqa: F401  (caps torch's CPU threads per process)
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from lsi_tpu_torch import native as tnative
from lsi_tpu_torch.evaluation.png import write_png


@pytest.fixture(scope="module")
def jnative(tmp_path_factory):
    from lsi_tpu import native
    if native._LIB is None and not native._TRIED:
        # A private build directory: another test process may be writing
        # the JAX package's library into its shared default one right now.
        native._CACHE_DIR = str(tmp_path_factory.mktemp("jax_native"))
    if not (native.available() and tnative.available()):
        pytest.skip("native loader toolchain unavailable: "
                    + tnative.build_error())
    return native


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Good, 16-bit, corrupt, truncated and missing images."""
    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(7)
    out = {}
    smooth = np.clip(np.cumsum(rng.normal(size=(45, 67, 3)), axis=1) * 9
                     + 128, 0, 255).astype(np.uint8)
    out["png"] = str(d / "a.png")
    Image.fromarray(smooth).save(out["png"])
    out["png_stdlib"] = str(d / "b.png")
    write_png(out["png_stdlib"], smooth[::-1].copy())
    out["jpeg"] = str(d / "c.jpg")
    Image.fromarray(smooth).save(out["jpeg"], quality=90)
    data = open(out["jpeg"], "rb").read()
    out["jpeg_truncated"] = str(d / "t.jpg")
    open(out["jpeg_truncated"], "wb").write(data[: len(data) // 3])
    out["jpeg_garbage"] = str(d / "g.jpg")
    open(out["jpeg_garbage"], "wb").write(
        b"\xff\xd8\xff" + bytes(rng.integers(0, 255, 64).tolist()))
    out["png_corrupt"] = str(d / "bad.png")
    open(out["png_corrupt"], "wb").write(b"\x89PNG\r\n\x1a\n" + b"\x00" * 32)
    arr16 = rng.integers(0, 65535, (16, 20, 3), dtype=np.uint16)

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    raw = b"".join(b"\x00" + row.astype(">u2").tobytes() for row in arr16)
    out["png_rgb16"] = str(d / "rgb16.png")
    open(out["png_rgb16"], "wb").write(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", 20, 16, 16, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    depth = ((np.arange(32 * 48, dtype=np.uint16).reshape(32, 48) * 7)
             % 60000)
    out["depth_pil"] = str(d / "d1.png")
    Image.fromarray(depth).save(out["depth_pil"])
    out["depth_stdlib"] = str(d / "d2.png")
    write_png(out["depth_stdlib"], depth)
    out["missing"] = str(d / "nope.png")
    return out


def test_builds_into_the_package(jnative):
    path = tnative.library_path()
    assert path.parent.name == "_build"
    assert path.parent.parent.name == "lsi_tpu_torch"
    assert path.exists() and tnative.build_error() == ""


@pytest.mark.parametrize("name", ["png", "png_stdlib", "jpeg", "png_rgb16",
                                  "jpeg_truncated", "jpeg_garbage",
                                  "png_corrupt", "missing"])
def test_decode_image_matches_jax(jnative, files, name):
    got = tnative.decode_image(files[name])
    want = jnative.decode_image(files[name])
    if want is None:
        assert got is None
        return
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if name.startswith("png") and name != "png_rgb16":
        np.testing.assert_array_equal(
            got, np.asarray(Image.open(files[name]).convert("RGB")))


@pytest.mark.parametrize("hw,threads", [((23, 31), 1), ((90, 134), 4),
                                        ((45, 67), 3)])
def test_load_batch_matches_jax(jnative, files, hw, threads):
    """Down-, up- and same-size resizes of a batch holding every kind of
    file: bitwise equal, failed slots zero on both sides."""
    paths = [files[k] for k in ("png", "jpeg", "jpeg_truncated", "missing",
                                "png_stdlib", "jpeg_garbage", "png_corrupt",
                                "png_rgb16")]
    got = tnative.load_batch(paths, *hw, num_threads=threads)
    want = jnative.load_batch(paths, *hw, num_threads=threads)
    assert got.shape == want.shape == (len(paths),) + hw + (3,)
    np.testing.assert_array_equal(got, want)
    assert got[0].max() > 0 and got[1].max() > 0
    for i in (3, 5, 6):
        assert float(got[i].max()) == 0.0


@pytest.mark.parametrize("name", ["depth_pil", "depth_stdlib", "png",
                                  "png_corrupt", "missing"])
def test_decode_depth16_matches_jax(jnative, files, name):
    got = tnative.decode_depth16(files[name])
    want = jnative.decode_depth16(files[name])
    if want is None:
        assert got is None
        return
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    if name.startswith("depth"):
        np.testing.assert_array_equal(got, np.asarray(Image.open(files[name])))
