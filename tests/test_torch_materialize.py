"""Materialized datasets and the prefetch thread, against the JAX package.

The port's shards hold the same bytes as JAX's for one seed (member by
member: the zip container stamps its own write time), through the library
call and through ``python -m lsi_tpu_torch.data.materialize`` with worker
processes; ``cached_example_stream`` gives the same examples in the same
order per split and epoch; ``data.root`` switches the synthetic stream to
the shards; the :class:`Prefetcher` gives bitwise the synchronous stream's
batches and raises a worker's error in the consumer without hanging.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from lsi_tpu.config import DataConfig as JDataConfig
from lsi_tpu.data import materialize as jmat
from lsi_tpu.data import pipeline as jpipe
from lsi_tpu_torch.config import DataConfig
from lsi_tpu_torch.data import materialize as tmat
from lsi_tpu_torch.data import pipeline as tpipe

REPO = Path(__file__).resolve().parent.parent
H, W, COUNT, SHARD = 16, 32, 7, 2


def shard_members(out_dir):
    """{file: {member: bytes}} of every shard, and the metadata."""
    files = sorted(p for p in os.listdir(out_dir) if p.startswith("shard_"))
    members = {}
    for f in files:
        with zipfile.ZipFile(os.path.join(out_dir, f)) as z:
            members[f] = {n: z.read(n) for n in z.namelist()}
    with open(os.path.join(out_dir, jmat.META_NAME)) as f:
        return members, json.load(f)


@pytest.fixture(scope="module", params=["multi", "two_plane"])
def shards(request, tmp_path_factory):
    kind = request.param
    jdir = tmp_path_factory.mktemp(f"jax_{kind}")
    tdir = tmp_path_factory.mktemp(f"torch_{kind}")
    n_j = jmat.materialize(str(jdir), kind=kind, seed=3, count=COUNT,
                           height=H, width=W, workers=0, shard_size=SHARD)
    n_t = tmat.materialize(str(tdir), kind=kind, seed=3, count=COUNT,
                           height=H, width=W, workers=0, shard_size=SHARD)
    assert n_j == n_t == 4
    return kind, str(jdir), str(tdir)


def test_shards_byte_equal_to_jax(shards):
    _, jdir, tdir = shards
    jm, jmeta = shard_members(jdir)
    tm, tmeta = shard_members(tdir)
    assert jmeta == tmeta
    assert list(tm) == list(jm)
    for f in jm:
        assert list(tm[f]) == list(jm[f]), f
        for name in jm[f]:
            assert tm[f][name] == jm[f][name], (f, name)


def test_materialize_cli_with_workers(shards, tmp_path):
    """The CLI, 2 forkserver workers, one shard size: the same members as
    JAX's in-process shards of the same scenes."""
    kind, jdir, _ = shards
    out = tmp_path / "cli"
    proc = subprocess.run(
        [sys.executable, "-m", "lsi_tpu_torch.data.materialize", "--out",
         str(out), "--scene", kind, "--seed", "3", "--count", str(COUNT),
         "--height", str(H), "--width", str(W), "--workers", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert f"wrote 1 shards ({COUNT} examples)" in proc.stdout
    got, meta = shard_members(out)
    assert meta["shard_size"] == tmat.SHARD_SIZE and meta["count"] == COUNT
    # One 64-example shard holds JAX's four shards' arrays, in order.
    want, _ = shard_members(jdir)
    with np.load(out / "shard_00000.npz") as data:
        for key in data.files:
            ref = np.concatenate([np.load(os.path.join(jdir, f))[key]
                                  for f in want])
            np.testing.assert_array_equal(data[key], ref, err_msg=key)


@pytest.mark.parametrize("split", ["all", "train", "val"])
def test_cached_example_stream_matches_jax(shards, split):
    """Two epochs of each split: the same examples in the same order, in
    the same storage dtypes."""
    _, jdir, tdir = shards
    jcfg = JDataConfig(root=jdir, height=H, width=W, split=split,
                       val_fraction=0.3)
    tcfg = DataConfig(root=tdir, height=H, width=W, split=split,
                      val_fraction=0.3)
    jit = jmat.cached_example_stream(jcfg, 5, True)
    tit = tmat.cached_example_stream(tcfg, 5, True)
    n = {"all": COUNT, "train": 5, "val": 2}[split]
    for _ in range(2 * n):
        a, b = next(tit), next(jit)
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_root_streams_the_shards(shards):
    """``data.root`` with ``dataset="synthetic"``: the port's batches (and
    their decode) equal JAX's, through both the synchronous stream and the
    prefetcher."""
    _, jdir, tdir = shards
    jcfg = JDataConfig(root=jdir, height=H, width=W, batch_size=3)
    tcfg = DataConfig(root=tdir, height=H, width=W, batch_size=3)
    ref = jpipe._batch_stream(jcfg, 2, True)
    sync = tpipe.batch_stream(tcfg, seed=2, device="cpu")
    pre = tpipe.make_dataset(tcfg, seed=2, device="cpu")
    try:
        for _ in range(3):
            want = next(ref)
            jdec = jpipe.decode_batch(want)
            for got in (next(sync), next(pre)):
                assert got.src_image.dtype == torch.uint8
                assert got.gt_disparity.dtype == torch.float16
                dec = tpipe.decode_batch(got)
                for f in dataclasses.fields(tpipe.Batch):
                    np.testing.assert_array_equal(
                        getattr(got, f.name).numpy(), getattr(want, f.name),
                        err_msg=f.name)
                    np.testing.assert_array_equal(
                        getattr(dec, f.name).numpy(),
                        np.asarray(getattr(jdec, f.name)), err_msg=f.name)
    finally:
        pre.close()


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetcher_equals_the_synchronous_stream(depth):
    """Online multi-object scenes, a data-parallel share of each batch, a
    single pass: the prefetched batches are the synchronous ones."""
    cfg = DataConfig(height=H, width=W, batch_size=4, prefetch=depth,
                     synthetic_scene="multi")
    share = slice(2, 4)
    sync = list(zip(range(3), tpipe.batch_stream(cfg, seed=1, device="cpu",
                                                 examples=share)))
    pre = tpipe.make_dataset(cfg, seed=1, device="cpu", examples=share)
    try:
        for _, want in sync:
            got = next(pre)
            assert got.src_image.shape == (2, H, W, 3)
            for f in dataclasses.fields(tpipe.Batch):
                assert torch.equal(getattr(got, f.name),
                                   getattr(want, f.name)), f.name
    finally:
        pre.close()
    with pytest.raises(StopIteration):
        next(pre)
    assert not pre._thread.is_alive()


def test_prefetcher_stress_keeps_order():
    """Twelve prefetchers (more threads than cores) consumed at once with
    a 1 us switch interval: every consumer gets each of its batches once,
    in order, within the time bound."""
    def arrays(tag, n):
        for i in range(n):
            yield {"src_image": np.full((1, 2, 2, 3), i, np.int64),
                   "trg_image": np.full((1, 2, 2, 3), tag, np.int64),
                   "intrinsics": np.zeros((1, 3, 3), np.float32),
                   "pose_src2trg": np.zeros((1, 4, 4), np.float32)}

    n, got = 200, {}

    def consume(tag):
        it = tpipe.Prefetcher(arrays(tag, n), depth=1 + tag % 3,
                              device="cpu")
        got[tag] = [(int(b.src_image[0, 0, 0, 0]),
                     int(b.trg_image[0, 0, 0, 0])) for b in it]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=consume, args=(t,), daemon=True)
                   for t in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert got == {t: [(i, t) for i in range(n)] for t in range(12)}


def _next_within(it, seconds):
    """``next(it)``'s exception (or None), raised by a helper thread that
    must finish within ``seconds``: the consumer may never hang."""
    out = {}

    def run():
        try:
            next(it)
        except BaseException as e:  # noqa: BLE001 — inspected below
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"next() still blocked after {seconds} s"
    return out.get("error")


@pytest.mark.parametrize("change", [{"root": "/nonexistent"},
                                    {"dataset": "kitti",
                                     "root": "/nonexistent"},
                                    {"dataset": "synthia",
                                     "root": "/nonexistent"}])
def test_bad_root_raises_in_the_consumer(change):
    """A bad ``data.root`` fails in the prefetch thread; the consumer gets
    FileNotFoundError on this ``next`` and every later one, each within
    30 s of its own."""
    cfg = dataclasses.replace(DataConfig(height=H, width=W, batch_size=2),
                              **change)
    it = tpipe.make_dataset(cfg, device="cpu")
    for _ in range(3):
        assert isinstance(_next_within(it, 30), FileNotFoundError)
    it._thread.join(30)
    assert not it._thread.is_alive()


def test_make_dataset_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.make_dataset(DataConfig(height=H, width=W, batch_size=2))
