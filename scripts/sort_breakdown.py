#!/usr/bin/env python3
"""Where K1-D's time goes: the deterministic splat (``csrc/splat_sort.cu``)
beside copies of it with one part taken out, on chip_smoke.py phase 30's
three input sets (the b8 kitti_ldi2 render's, the kitti_ldi3_quality
step's full LDI's, a height shard's).

    python3 scripts/sort_breakdown.py [--out FILE]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
Each copy is built from a text edit of the source into a library of its
own under ``lsi_tpu_torch/_build/breakdown/`` and called with the plan
``splat_cuda.sort_plan`` gives; the copies' outputs are wrong by design
(they answer a question of time, not of value), the tree's own is held
bitwise to ``splat(..., deterministic=True)``. For each input, each
copy's time by CUDA events, in turns with the tree's, and alone by kernel
(torch.profiler):

* ``tree``: the source as it is;
* ``fill without stores``: the fill computes every slot and stores none
  (its atomics' results then go unused, so the compiler also makes them
  atomics that return nothing);
* ``fill without returning atomics``: the fill adds to the cursors with
  atomics whose results it does not use and stores each position at the
  slot a plain load of the cursor gives, as scattered as the real ones;
* ``count with returning atomics``: the count uses the atomics' results;
* ``sum without its sort``: the sum adds each run in the order it finds.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from lsi_tpu_torch.kernels import build, splat_cuda  # noqa: E402

SOURCE = build.CSRC_DIR / "splat_sort.cu"
STORE = "    if (t[k] >= 0) pos[at] = static_cast<int>(k * g.np + i);"
FILL_ATOMIC = """    slot[k] = t[k] >= 0 && rank[k] == 0 ? atomicAdd(&cursor[t[k]], size[k])
                                        : 0;"""
COUNT_ATOMIC = ("    if (t[k] >= 0 && rank == 0) atomicAdd(&cursor[t[k]], "
                "size);")
DECODE = "  const int k = q >= 2 * np"
SORTS = ("    sort_registers<8>(p);", "    sort_registers<16>(p);",
         "    sort_registers<kShortRun>(p);")

# name -> [(text, replacement)]
COPIES = {
    "tree": [],
    "fill without stores": [
        (STORE, "    if (t[k] >= 0 && at == -7) pos[0] = at;")],
    "fill without returning atomics": [
        (FILL_ATOMIC, "    slot[k] = 0;\n"
         "    if (t[k] >= 0 && rank[k] == 0) {\n"
         "      atomicAdd(&cursor[t[k]], size[k]);\n"
         "      slot[k] = cursor[t[k]];\n"
         "    }"),
        # Its slots are not the runs' own: keep every position in range.
        (DECODE, "  q = min(max(q, 0), 4 * np - 1);\n" + DECODE)],
    "count with returning atomics": [
        (COUNT_ATOMIC, "    if (t[k] >= 0 && rank == 0 &&\n"
         "        atomicAdd(&cursor[t[k]], size) == -12345) {\n"
         "      cursor[0] = 0;\n"
         "    }")],
    "sum without its sort": [(s, "    ;") for s in SORTS],
}


def build_copy(item):
    """Compile one copy of the source, edited, into its own library."""
    name, edits = item
    text = SOURCE.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{name}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    out = build.BUILD_DIR / "breakdown"
    out.mkdir(parents=True, exist_ok=True)
    tag = name.replace(" ", "_")
    (out / f"{tag}.cu").write_text(text)
    lib = out / f"lib{tag}.so"
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                    str(lib), str(out / f"{tag}.cu")], check=True)
    return name, lib


def caller(lib, dev, values, coords, weights, out_hw, snap, window):
    """A call of one copy's lsi_splat_sort as _launch_sort makes it."""
    n, hs, ws, c = values.shape
    plan = splat_cuda.sort_plan(values.shape, out_hw)

    def call():
        scratch = torch.empty(plan.scratch_ints, dtype=torch.int32,
                              device=dev)
        accum = torch.empty((n, *out_hw, c), device=dev)
        wsum = None if weights is None else torch.empty((n, *out_hw, 1),
                                                        device=dev)
        err = lib.lsi_splat_sort(
            values.data_ptr(), coords.data_ptr(),
            0 if weights is None else weights.data_ptr(), accum.data_ptr(),
            0 if wsum is None else wsum.data_ptr(), scratch.data_ptr(), n,
            hs, ws, c, *out_hw, int(snap), *window, plan.long_capacity,
            plan.long_blocks, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"lsi_splat_sort failed: cudaError {err}")
        return accum, wsum
    return call


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, help="also write JSON there")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"]).splitlines()[0]
    print(smi, flush=True)
    with concurrent.futures.ThreadPoolExecutor(len(COPIES)) as pool:
        built = dict(pool.map(build_copy, COPIES.items()))
    libs = {}
    for name, path in built.items():
        lib = ctypes.CDLL(str(path))
        lib.lsi_splat_sort.argtypes = (
            build.LIBRARIES["splat_sort"][1]["lsi_splat_sort"])
        lib.lsi_splat_sort.restype = ctypes.c_int
        libs[name] = lib
    sets, _ = cs.sort_inputs(dev)
    rows = []
    for label, *inputs in sets:
        values, coords, weights, out_hw, snap = inputs[:5]
        window = inputs[5] if len(inputs) > 5 else (-1, 1, 0)

        def tree():
            return splat_cuda.splat(values, coords, weights, out_hw,
                                    snap=snap, max_dy=window[0],
                                    fold_h=window[1], base_offset=window[2],
                                    deterministic=True)

        want = tree()
        for name, lib in libs.items():
            fn = caller(lib, dev, values, coords, weights, out_hw, snap,
                        window)
            got = fn()
            same = all(torch.equal(a, b) for a, b in zip(got, want)
                       if b is not None)
            if name == "tree" and not same:
                raise SystemExit(f"{label}: the tree's copy differs")
            t, readings = cs.in_turns({"plain": tree, "kernel": fn},
                                      iters=20)
            alone, parts, others = cs.call_device_us(fn)
            rows.append(dict(inputs=label, copy=name, us=1e3 * t["kernel"],
                             tree_us=1e3 * t["plain"], readings=readings,
                             alone_us=alone, parts=parts,
                             bitwise_equal=same))
            print(f"{smi} | K1-D {label}, {name}: {1e3 * t['kernel']:.1f} "
                  f"us by events (the tree's {1e3 * t['plain']:.1f}); alone "
                  f"{alone:.1f}: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                               parts.items())
                  + f"; bitwise the tree's {same}", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, "rows": rows},
                                       indent=1))


if __name__ == "__main__":
    main()
