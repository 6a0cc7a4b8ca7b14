"""The harness finds a cell, a configuration, a traffic mix and a
per-layer metric by their names: a later change adds files and entries
and edits no file that is there."""

import hashlib
import json
import shutil

from h100_bench.harness.spec import BENCH_DIR, ROOT, load_cell, load_reader


def digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_and_entries_add_a_cell_a_config_and_a_metric(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "h100_bench"
    before = digest(bench)

    cfg = json.load(open(bench / "configs" / "kitti_ldi2.json"))
    cfg["name"] = "kitti_ldi2_sort"
    cfg["set"] = ["render.splat_method=sort"]
    cfg["config"]["render"]["splat_method"] = "sort"
    json.dump(cfg, open(bench / "configs" / "kitti_ldi2_sort.json", "w"))
    traffic = json.load(open(bench / "traffic" / "serve_closed_b16.json"))
    traffic["batch_size"] = 8
    json.dump(traffic, open(bench / "traffic" / "serve_closed_b8.json", "w"))
    json.dump({"ldi_gap": 0.1, "frame_gap": 0.1},
              open(bench / "limits" / "serve_b8_sort.json", "w"))
    (bench / "metrics" / "k1d_launches.serve.py").write_text(
        "def read(run):\n    return run.trace.counters['splat.sort_launches']"
        " / run.trace.iterations\n")

    spec = json.load(open(tmp_path / "BENCHMARK.json"))
    spec["configs"].append({"name": "kitti_ldi2_sort", "source": "x",
                            "file": "h100_bench/configs/kitti_ldi2_sort.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "serve_b8_sort",
                              "config": "kitti_ldi2_sort",
                              "traffic": "serve_closed_b8", "chips": 1,
                              "why": "x"})
    for m in spec["end_to_end"]:
        if "serve_b16" in m.get("workloads", []):
            m["workloads"].append("serve_b8_sort")
    spec["per_layer"].append({"name": "k1d_launches.serve", "unit": "count",
                              "better": "lower", "source": "program_counter",
                              "layer": "Kernels", "moves":
                              "serve_frames_per_s",
                              "workloads": ["serve_b8_sort"]})
    json.dump(spec, open(tmp_path / "BENCHMARK.json", "w"))

    cell = load_cell("serve_b8_sort", root=tmp_path)
    assert cell.config["config"]["render"]["splat_method"] == "sort"
    assert cell.traffic["batch_size"] == 8
    assert cell.limits == {"ldi_gap": 0.1, "frame_gap": 0.1}
    assert {m["name"] for m in cell.end_to_end} == {
        "serve_frames_per_s", "serve_batch_ms_p95", "setup_s"}
    assert [m["name"] for m in cell.per_layer] == ["k1d_launches.serve"]
    read = load_reader("k1d_launches.serve", bench_dir=bench)

    class T:
        counters = {"splat.sort_launches": 6}
        iterations = 3

    class R:
        trace = T()
    assert read(R()) == 2
    after = digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before


def test_every_cell_loads_with_its_parts():
    spec = json.load(open(ROOT / "BENCHMARK.json"))
    for w in spec["workloads"]:
        cell = load_cell(w["name"])
        assert set(cell.limits)
        for m in cell.per_layer:
            load_reader(m["name"])
