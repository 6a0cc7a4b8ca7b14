#!/usr/bin/env python3
"""Time this tree's K1 and gather kernels against another tree's (the
parent commit's) on the same card, in the same process, on the same
inputs.

    git archive <parent> | tar -x -C _scratch/parent
    python3 scripts/compare_parent_kernels.py --parent _scratch/parent

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
Both trees' kernel libraries are built from their own ``csrc/`` (the
parent's through its own ``kernels/build.py``). Inputs: chip_smoke.py's
random +-40 px ones at the b8 render and b16 train shapes, and the main
path's own, recorded during one kitti_ldi2 b8 render and one
kitti_ldi3_b16 b16 train step (random weights from seed 0, as in
chip_smoke.py). For each:

* K1 (``lsi_splat_fwd``) and ``lsi_gather_fwd``, parent and change timed
  in turns (parent, change, change, parent) with CUDA events; outputs held
  to each other (K1 at chip_smoke.py's splat tolerance, the gather
  bitwise); the share of K1's blocks that accumulate in shared memory
  (from the tiling the wrapper chooses);
* ``lsi_splat_vjp`` and ``lsi_gather_bwd_coords``, which this tree must
  leave as they were: outputs bitwise equal, times in turns;
* the windowed K1 on the windowed main paths' own inputs (the route's
  quality step, a height shard, the route's serving render, the sweep,
  the route's MPI step): the parent's box kernel against this tree's K1
  as ``splat`` launches it (``use_band``'s choice) and, where that is the
  box kernel, against the band kernel too, in turns, outputs held to
  each other at chip_smoke.py's splat tolerance; and K1 as the MPI step's
  image gradient, the parent with the unit weights and discarded wsum
  its ``GatherFn`` passed, this tree without them.

Also prints each kernel's registers, shared memory and spills from
``nvcc -Xptxas -v``, the atomic instructions in the K1 library's SASS
(``cuobjdump``: a shared-memory float atomicAdd is a compare-and-swap
loop, ``ATOMS.CAST.SPIN``), and, for each windowed input, the share of
corners that aim at the pixel another lane's same corner aims at in a
warp of 32 neighbouring pixels (those compare-and-swaps retry); with
``--out``, writes everything there as JSON.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import importlib.util
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from lsi_tpu_torch.api import LSIModel  # noqa: E402
from lsi_tpu_torch.config import build_config, get_config  # noqa: E402
from lsi_tpu_torch.data.pipeline import batch_stream  # noqa: E402
from lsi_tpu_torch.geometry.ldi import LDI  # noqa: E402
from lsi_tpu_torch.geometry.transforms import translation_pose  # noqa: E402
from lsi_tpu_torch.kernels import build, gather_cuda, splat_cuda  # noqa: E402
from lsi_tpu_torch.ops.splat import snap_fraction  # noqa: E402
from lsi_tpu_torch.train.trainer import create_state, make_train_step  # noqa: E402


# The parent's K1 and lsi_splat_vjp end their arguments with a window
# (max_dy, fold_h, base_offset), its gathers with (max_dy, fold_h); here
# none.
NO_WINDOW = (-1, 1, 0)


def load_parent_build(parent: Path):
    """The parent tree's ``kernels/build.py`` as its own module: it builds
    and loads the parent's libraries from the parent's ``csrc/``."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", parent / "lsi_tpu_torch" / "kernels" / "build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas_report() -> str:
    """Registers, shared memory and spills of every kernel of this tree."""
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        for sources, _ in build.LIBRARIES.values():
            for src in sources:
                cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas",
                       "-v", "-c", "-o", f"{tmp}/{Path(src).stem}.o",
                       str(build.CSRC_DIR / src)]
                out = subprocess.run(cmd, capture_output=True, text=True)
                lines += [ln for ln in (out.stdout + out.stderr).splitlines()
                          if "Compiling entry" in ln or "Used" in ln
                          or "spill" in ln]
    return "\n".join(lines)


def sass_atomics() -> str:
    """Counts of the atomic instructions in the K1 library's SASS."""
    out = subprocess.run(
        [str(Path(build.find_nvcc()).parent / "cuobjdump"), "-sass",
         str(build.library_path("splat_fwd"))],
        capture_output=True, text=True).stdout
    found = collections.Counter(m.group(0) for m in re.finditer(
        r"\b(?:ATOMS|ATOM|RED)[A-Z0-9_.]*", out))
    return ", ".join(f"{k} {v}" for k, v in sorted(found.items()))


def warp_collisions(coords, out_hw):
    """Per corner (00, 01, 10, 11), the share of in-image corners of 32
    neighbouring pixels of a row whose target another of them shares."""
    n, hs, ws, _ = coords.shape
    g = ws // 32
    x0 = torch.floor(coords[..., 0])[:, :, :g * 32]
    y0 = torch.floor(coords[..., 1])[:, :, :g * 32]
    lane = torch.arange(g * 32, device=coords.device, dtype=torch.float32)
    shares = []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        x, y = x0 + dx, y0 + dy
        ok = (x >= 0) & (x <= out_hw[1] - 1) & (y >= 0) & (y <= out_hw[0] - 1)
        t = torch.where(ok, y * out_hw[1] + x, -1 - lane.expand_as(x))
        t = t.reshape(n, hs, g, 32).sort(-1).values
        same = (t[..., 1:] == t[..., :-1]) & (t[..., 1:] >= 0)
        shares.append(float(same.sum()) / max(float(ok.sum()), 1.0))
    return shares


def in_turns(parent_fn, change_fn, iters: int):
    times = {"parent": [], "change": []}
    for which, fn in (("parent", parent_fn), ("change", change_fn),
                      ("change", change_fn), ("parent", parent_fn)):
        times[which].append(cs.cuda_ms(fn, iters=iters))
    return {k: float(np.mean(v)) for k, v in times.items()}, times


def splat_smem_share(coords, out_hw, tiling, c: int) -> float:
    """Share of K1's blocks with a live corner whose box fits shared
    memory (the kernel's pass 1, in PyTorch)."""
    n, hs, ws, _ = coords.shape
    th, tw = tiling.tile
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = snap_fraction(x - x0), snap_fraction(y - y0)
    lo_x = hi_x = lo_y = hi_y = None
    for k in range(4):
        dx, dy = k & 1, k >> 1
        frac = (fx if dx else 1 - fx) * (fy if dy else 1 - fy)
        cx, cy = x0 + dx, y0 + dy
        live = ((frac > 0) & (cx >= 0) & (cx <= out_hw[1] - 1) & (cy >= 0)
                & (cy <= out_hw[0] - 1))
        inf = torch.full_like(cx, float("inf"))
        parts = (torch.where(live, cx, inf), torch.where(live, cx, -inf),
                 torch.where(live, cy, inf), torch.where(live, cy, -inf))
        if lo_x is None:
            lo_x, hi_x, lo_y, hi_y = parts
        else:
            lo_x, hi_x = torch.minimum(lo_x, parts[0]), torch.maximum(hi_x, parts[1])
            lo_y, hi_y = torch.minimum(lo_y, parts[2]), torch.maximum(hi_y, parts[3])
    gy, gx = -(-hs // th), -(-ws // tw)

    def per_tile(t, fill, op):
        t = torch.nn.functional.pad(t, (0, gx * tw - ws, 0, gy * th - hs),
                                    value=fill)
        return getattr(t.reshape(n, gy, th, gx, tw), op)(dim=(2, 4))

    lx, hx = per_tile(lo_x, float("inf"), "amin"), per_tile(hi_x, -float("inf"), "amax")
    ly, hy = per_tile(lo_y, float("inf"), "amin"), per_tile(hi_y, -float("inf"), "amax")
    used = lx <= hx
    px = (hx - lx + 1) * (hy - ly + 1)
    fits = used & (px * (c + 1) * 4 <= tiling.smem_bytes)
    return float(fits.sum()) / max(float(used.sum()), 1.0)


SPLAT_SWEEP = [dict(block_x=bx, rows_per_thread=rpt, smem_bytes=kb * 1024)
               for bx, rpt, kb in ((128, 2, 32), (128, 2, 0), (64, 1, 32),
                                   (64, 1, 0), (128, 2, 40), (32, 2, 16))]
GATHER_SWEEP = [dict(max_tile_rows=tr) for tr in (4, 2, 1)]


def sweep(dev, splat_sets, gather_sets):
    """This tree's K1 and lsi_gather_fwd under each tiling of SPLAT_SWEEP
    and GATHER_SWEEP, and the two torch.zeros of K1's wrapper alone."""
    rows = []
    for label, (v, c, w, hw, snap) in splat_sets.items():
        n, _, _, ch = v.shape
        zeros = cs.cuda_ms(lambda: (torch.zeros((n, *hw, ch), device=dev),
                                    torch.zeros((n, *hw, 1), device=dev)),
                           iters=20)
        rows.append(dict(kernel="K1 zeros only", inputs=label,
                         us=1e3 * zeros))
        print(f"sweep K1 {label}: the wrapper's zeros alone "
              f"{1e3 * zeros:.1f} us", flush=True)
        for kw in SPLAT_SWEEP:
            t = splat_cuda.splat_tiling(v.shape, hw, aligned16=True, **kw)
            ms = cs.cuda_ms(lambda: splat_cuda._launch_splat(
                v, c, w, hw, snap, t), iters=20)
            share = splat_smem_share(c, hw, t, ch)
            rows.append(dict(kernel="K1", inputs=label, tiling=kw,
                             us=1e3 * ms, smem_block_share=share))
            print(f"sweep K1 {label} {kw}: {1e3 * ms:.1f} us, "
                  f"{share:.1%} in shared memory", flush=True)
    for label, (image, coords) in gather_sets.items():
        for kw in GATHER_SWEEP:
            t = gather_cuda.gather_tiling(image.shape, coords.shape, **kw)
            ms = cs.cuda_ms(lambda: gather_cuda._launch_gather_fwd(
                image, coords, t), iters=20)
            rows.append(dict(kernel="lsi_gather_fwd", inputs=label,
                             tiling=kw, us=1e3 * ms))
            print(f"sweep lsi_gather_fwd {label} {kw}: {1e3 * ms:.1f} us",
                  flush=True)
    return rows


def record_windowed(dev):
    """The windowed K1's inputs (values, coords, weights, out_hw, snap,
    window) on the route (render.use_pallas="on"): one quality step's full
    LDI, one kitti_ldi2 b8 render, a sweep's first chunk and one MPI
    step's planes' gradient; a height shard's (chip_smoke.py phase 19);
    and the unwindowed MPI step's planes' gradient."""
    from lsi_tpu_torch.evaluation.trajectory import render_trajectory
    out = {}
    cfg = build_config("kitti_ldi3_quality", cs.ROUTE_ON)
    state = create_state(cfg, seed=0, device=dev)
    batch = next(batch_stream(cfg.data, seed=0, device=dev))
    with cs.recording(windowed=True) as calls:
        make_train_step(cfg)(state, batch)
    h = cfg.data.height
    out["route quality step's own (full LDI)"] = next(
        c for c in calls["splat_fwd"]
        if c[0].shape[1] == 3 * h and c[2] is not None)
    del state, batch, calls
    config = build_config("kitti_ldi2", ["render.use_pallas=on"])
    h, w = config.data.height, config.data.width
    model = LSIModel.init(0, config, h, w, device=dev)
    rng = np.random.default_rng(1)
    image = torch.from_numpy(rng.uniform(size=(cs.BATCH, h, w, 3))
                             .astype(np.float32)).to(dev)
    pose = translation_pose([[-0.3, 0.0, 0.0]] * cs.BATCH).to(dev)
    with cs.recording(windowed=True) as calls:
        ldi = model.predict_ldi(image)
        model.render(ldi, pose)
    out["route b8 kitti_ldi2 render's own"] = calls["splat_fwd"][0]
    sweep = build_config("trajectory_sweep", ["render.use_pallas=on"])
    one = LDI(textures=ldi.textures[:1].float(),
              disparities=ldi.disparities[:1].float(),
              intrinsics=ldi.intrinsics[:1].float())
    with torch.no_grad(), cs.recording(windowed=True) as calls:
        render_trajectory(one, 60, (0.15, 0.0, 0.0), (0.0, 0.0, 0.01),
                          sweep.render)
    out["route sweep's own (first chunk, window 16)"] = calls["splat_fwd"][0]
    del model, ldi, one, calls
    ldi, pose, zscale = cs.spatial_ldi(dev, 8)
    hd = ldi.height // cs.SPATIAL_S
    shard = LDI(textures=ldi.textures[:, :, hd:2 * hd],
                disparities=ldi.disparities[:, :, hd:2 * hd],
                intrinsics=ldi.intrinsics)
    shift = cs.global_shift(ldi, pose, zscale)
    with torch.no_grad():
        values, coords, weights, out_hw, window = cs.shard_splat_args(
            shard, pose, None, zscale, hd, cs.SPATIAL_MAX_DY,
            lambda t: shift)
    out["height shard 1 of 4's own"] = (values, coords, weights, out_hw,
                                        True, window)
    del ldi, shard
    for on in (True, False):
        cfg = build_config("mpi_baseline",
                           ["render.use_pallas=on"] if on else [])
        state = create_state(cfg, seed=0, device=dev)
        batch = next(batch_stream(cfg.data, seed=0, device=dev))
        with cs.recording(windowed=on) as calls:
            make_train_step(cfg)(state, batch)
        label = ("route MPI step's own (the planes' gradient)" if on else
                 "MPI step's own (the planes' gradient, unwindowed)")
        out[label] = calls["splat_fwd"][0] + (() if on else (NO_WINDOW,))
        del state, batch, calls
    return out


def record_main_path(dev):
    """K1's inputs in one b8 kitti_ldi2 render and K1's and the gather's
    in one b16 kitti_ldi3_b16 train step (chip_smoke.py's phases 5 and
    10)."""
    config = get_config("kitti_ldi2")
    h, w = config.data.height, config.data.width
    model = LSIModel.init(0, config, h, w, device=dev)
    rng = np.random.default_rng(1)
    image = torch.from_numpy(rng.uniform(size=(cs.BATCH, h, w, 3))
                             .astype(np.float32)).to(dev)
    pose = translation_pose([[-0.3, 0.0, 0.0]] * cs.BATCH).to(dev)
    with cs.recording() as serve:
        model.render(model.predict_ldi(image), pose)
    del model
    config = get_config("kitti_ldi3_b16")
    config = dataclasses.replace(config, data=dataclasses.replace(
        config.data, dataset="synthetic"))
    state = create_state(config, seed=0, device=dev)
    batch = next(batch_stream(config.data, seed=0, device=dev))
    with cs.recording() as train:
        make_train_step(config)(state, batch)
    return serve["splat_fwd"][0], train["splat_fwd"][0], train["gather_fwd"][0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="root of the other tree (e.g. _scratch/parent)")
    ap.add_argument("--sweep", action="store_true",
                    help="also time this tree's kernels under other tilings")
    ap.add_argument("--out", type=Path,
                    help="also write the results there as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"]).splitlines()[0]
    print(smi, flush=True)
    ptxas = ptxas_report()
    print(ptxas, flush=True)
    atomics = sass_atomics()
    print(f"SASS atomics of the K1 library: {atomics}", flush=True)
    pb = load_parent_build(args.parent.resolve())
    for name in pb.LIBRARIES:
        pb.load(name)
    result = {"card": smi, "ptxas": ptxas, "sass_atomics": atomics,
              "k1": [], "k1_window": [],
              "gather_fwd": [], "splat_vjp": [], "gather_bwd_coords": []}

    # The parent's entry points take the tiling this tree's wrappers choose
    # for the box kernel. The parent's K1 takes unit weights where this
    # tree's takes none (the gather's image gradient): made here, as the
    # parent's GatherFn made them.
    def parent_splat(values, coords, weights, out_hw, snap,
                     window=NO_WINDOW):
        n, hs, ws, c = values.shape
        if weights is None:
            weights = torch.ones((n, hs, ws, 1), device=dev)
        acc = torch.zeros((n, *out_hw, c), device=dev)
        wsum = torch.zeros((n, *out_hw, 1), device=dev)
        t = splat_cuda.splat_tiling(values.shape, out_hw, aligned16=all(
            x.data_ptr() % 16 == 0 for x in (values, acc)))
        pb.launch("splat_fwd", "lsi_splat_fwd", dev, values.data_ptr(),
                  coords.data_ptr(), weights.data_ptr(), acc.data_ptr(),
                  wsum.data_ptr(), n, hs, ws, c, *out_hw, int(snap),
                  t.block[0], t.tile[0], t.smem_bytes, int(t.vec4),
                  *window)
        return acc, wsum

    def parent_gather(image, coords):
        n, hi, wi, c = image.shape
        _, hs, ws, _ = coords.shape
        sampled = torch.empty((n, hs, ws, c), device=dev)
        valid = torch.empty((n, hs, ws, 1), device=dev)
        t = gather_cuda.gather_tiling(image.shape, coords.shape)
        pb.launch("splat_bwd", "lsi_gather_fwd", dev, image.data_ptr(),
                  coords.data_ptr(), sampled.data_ptr(), valid.data_ptr(),
                  n, hs, ws, c, hi, wi, t.grid[1], t.tile[0], t.row_stride,
                  *NO_WINDOW[:2])
        return sampled, valid

    def parent_vjp(values, coords, weights, g_acc, g_ws, out_hw):
        n, hs, ws, c = values.shape
        outs = [torch.empty_like(t) for t in (values, coords, weights)]
        pb.launch("splat_bwd", "lsi_splat_vjp", dev, values.data_ptr(),
                  coords.data_ptr(), weights.data_ptr(), g_acc.data_ptr(),
                  g_ws.data_ptr(), *(t.data_ptr() for t in outs), n, hs, ws,
                  c, *out_hw, *NO_WINDOW)
        return outs

    def parent_gather_bwd(image, coords, g_s, g_v):
        n, hi, wi, c = image.shape
        _, hs, ws, _ = coords.shape
        d = torch.empty_like(coords)
        pb.launch("splat_bwd", "lsi_gather_bwd_coords", dev,
                  image.data_ptr(), coords.data_ptr(), g_s.data_ptr(),
                  g_v.data_ptr(), d.data_ptr(), n, hs, ws, c, hi, wi,
                  *NO_WINDOW[:2])
        return d

    windowed = record_windowed(dev)
    for label, (v, c, w, hw, snap, window) in windowed.items():
        # This tree as splat launches it (use_band's choice), and the band
        # kernel where that is not it (the reading the rule rests on).
        trees = {"change": lambda: splat_cuda.splat(
            v, c, w, hw, snap=snap, max_dy=window[0], fold_h=window[1],
            base_offset=window[2])}
        band = window[0] >= 0 and splat_cuda.band_plan(v, hw, window,
                                                        w) is not None
        if window[0] >= 0 and not band:
            tiling = splat_cuda.band_tiling(
                v.shape, hw, window, weights=w is not None,
                aligned16=v.data_ptr() % 16 == 0)
            trees["band"] = lambda: splat_cuda._launch_splat(
                v, c, w, hw, snap, tiling, window)
        theirs = parent_splat(v, c, w, hw, snap, window)
        if w is None:
            theirs = (theirs[0], None)
        err = max(cs.check_close(f"K1 parent vs {k} {label}", a, b,
                                 cs.SPLAT_RTOL, cs.SPLAT_ATOL_OF_MAX
                                 * b.abs().max().item())
                  for k, fn in trees.items()
                  for a, b in zip(fn(), theirs) if b is not None)
        bnd = cs.k1_bound(v, c, w, hw,
                          window if window[0] >= 0 else NO_WINDOW)
        row = dict(inputs=label, shape=list(v.shape), out_hw=list(hw),
                   window=list(window), weights=w is not None,
                   change_kernel="band" if band else "box",
                   bound_us=1e3 * bnd[0], max_abs_diff=err,
                   warp_collisions=warp_collisions(c, hw))
        parent_alone = cs.kernel_device_us(
            lambda: parent_splat(v, c, w, hw, snap, window),
            "splat_fwd_kernel", required=False)
        line = []
        for k, fn in trees.items():
            t, readings = in_turns(lambda: parent_splat(v, c, w, hw, snap,
                                                        window), fn, 20)
            kernel = ("splat_band_kernel" if k == "band" or band
                      else "splat_fwd_kernel")
            alone = cs.kernel_device_us(fn, kernel, required=False)
            row[k] = dict(parent_us=1e3 * t["parent"],
                          us=1e3 * t["change"], readings=readings,
                          parent_alone_us=parent_alone, alone_us=alone,
                          speedup=t["parent"] / t["change"])
            line.append(f"{k} ({'band' if kernel == 'splat_band_kernel' else 'box'}) "
                        f"{row[k]['us']:.1f} us against the parent's "
                        f"{row[k]['parent_us']:.1f} ({row[k]['speedup']:.2f}x) "
                        f"by events, alone {alone} against {parent_alone}")
        result["k1_window"].append(row)
        print(f"K1 {label} {tuple(v.shape)} -> {tuple(hw)} window "
              f"{tuple(window)}{'' if w is not None else ', no weights'}: "
              + "; ".join(line) + f"; bound {row['bound_us']:.1f} us; max "
              f"|this tree - parent| {err:.3e}; corners sharing a target "
              f"in a warp {[round(x, 4) for x in row['warp_collisions']]}",
              flush=True)
    del windowed
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    render_in, step_splat_in, step_gather_in = record_main_path(dev)
    splat_sets = {
        "random +-40 px, b8 render shape": (
            *cs.splat_inputs(rng, dev), cs.OUT_HW, True),
        "b8 kitti_ldi2 render's own inputs": render_in,
        "random +-40 px, b16 train shape": (
            *cs.splat_inputs(rng, dev, cs.TRAIN_SPLAT_SHAPE), cs.OUT_HW,
            True),
        "b16 kitti_ldi3_b16 step's own inputs": step_splat_in,
    }
    gather_sets = {
        "random +-40 px, b16 inverse warp shape": cs.gather_inputs(rng, dev),
        "b16 kitti_ldi3_b16 step's own inputs": step_gather_in,
    }
    gen = torch.Generator(device=dev).manual_seed(5)

    for label, (v, c, w, hw, snap) in splat_sets.items():
        mine = splat_cuda.splat(v, c, w, hw, snap=snap)
        theirs = parent_splat(v, c, w, hw, snap)
        err = max(cs.check_close(f"K1 parent vs change {label}", a, b,
                                 cs.SPLAT_RTOL, cs.SPLAT_ATOL_OF_MAX
                                 * b.abs().max().item())
                  for a, b in zip(mine, theirs))
        t, readings = in_turns(lambda: parent_splat(v, c, w, hw, snap),
                               lambda: splat_cuda.splat(v, c, w, hw,
                                                        snap=snap), 20)
        tiling = splat_cuda.splat_tiling(v.shape, hw, aligned16=True)
        share = splat_smem_share(c, hw, tiling, v.shape[-1])
        bnd = cs.k1_bound(v, c, w, hw)
        row = dict(inputs=label, shape=list(v.shape), parent_us=1e3 * t["parent"],
                   change_us=1e3 * t["change"], readings=readings,
                   speedup=t["parent"] / t["change"], bound_us=1e3 * bnd[0],
                   smem_block_share=share, max_abs_diff=err)
        result["k1"].append(row)
        print(f"K1 {label}: parent {row['parent_us']:.1f} us, change "
              f"{row['change_us']:.1f} us ({row['speedup']:.2f}x), bound "
              f"{row['bound_us']:.1f} us; {share:.1%} of blocks in shared "
              f"memory; max |change - parent| {err:.3e}", flush=True)
        if label.startswith("random +-40 px, b16"):
            cots = (torch.randn((v.shape[0], *hw, v.shape[-1]), generator=gen,
                                device=dev),
                    torch.randn((v.shape[0], *hw, 1), generator=gen,
                                device=dev))
            mine = splat_cuda.splat_vjp(v, c, w, *cots, hw)
            theirs = parent_vjp(v, c, w, *cots, hw)
            same = all(torch.equal(a, b) for a, b in zip(mine, theirs))
            t, readings = in_turns(
                lambda: parent_vjp(v, c, w, *cots, hw),
                lambda: splat_cuda.splat_vjp(v, c, w, *cots, hw), 10)
            result["splat_vjp"].append(dict(
                inputs=label, parent_us=1e3 * t["parent"],
                change_us=1e3 * t["change"], readings=readings,
                bitwise_equal=same))
            print(f"lsi_splat_vjp {label}: parent {1e3 * t['parent']:.1f} "
                  f"us, change {1e3 * t['change']:.1f} us; bitwise equal "
                  f"{same}", flush=True)
    splat_sets_for_sweep = splat_sets if args.sweep else None
    del splat_sets, render_in, step_splat_in

    for label, (image, coords) in gather_sets.items():
        mine = gather_cuda.gather_fwd(image, coords)
        theirs = parent_gather(image, coords)
        same = all(torch.equal(a, b) for a, b in zip(mine, theirs))
        t, readings = in_turns(lambda: parent_gather(image, coords),
                               lambda: gather_cuda.gather_fwd(image, coords),
                               20)
        img4, grid = cs.grid_sample_args(image, coords)
        lib = cs.cuda_ms(lambda: torch.nn.functional.grid_sample(
            img4, grid, **cs.GS_KW), iters=20)
        row = dict(inputs=label, parent_us=1e3 * t["parent"],
                   change_us=1e3 * t["change"], readings=readings,
                   grid_sample_us=1e3 * lib, bitwise_equal=same)
        result["gather_fwd"].append(row)
        print(f"lsi_gather_fwd {label}: parent {row['parent_us']:.1f} us, "
              f"change {row['change_us']:.1f} us, grid_sample "
              f"{row['grid_sample_us']:.1f} us; bitwise equal {same}",
              flush=True)
        cots = (torch.randn(coords.shape[:-1] + (image.shape[-1],),
                            generator=gen, device=dev),
                torch.randn(coords.shape[:-1] + (1,), generator=gen,
                            device=dev))
        mine = gather_cuda.gather_bwd_coords(image, coords, *cots)
        theirs = parent_gather_bwd(image, coords, *cots)
        same = torch.equal(mine, theirs)
        t, readings = in_turns(
            lambda: parent_gather_bwd(image, coords, *cots),
            lambda: gather_cuda.gather_bwd_coords(image, coords, *cots), 20)
        result["gather_bwd_coords"].append(dict(
            inputs=label, parent_us=1e3 * t["parent"],
            change_us=1e3 * t["change"], readings=readings,
            bitwise_equal=same))
        print(f"lsi_gather_bwd_coords {label}: parent "
              f"{1e3 * t['parent']:.1f} us, change {1e3 * t['change']:.1f} "
              f"us; bitwise equal {same}", flush=True)

    if args.sweep:
        result["sweep"] = sweep(dev, splat_sets_for_sweep, gather_sets)

    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    bad = [k for k in ("splat_vjp", "gather_bwd_coords", "gather_fwd")
           for r in result[k] if not r["bitwise_equal"]]
    if bad:
        raise SystemExit(f"not bitwise equal to the parent: {bad}")


if __name__ == "__main__":
    main()
