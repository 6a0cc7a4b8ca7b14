"""The LDI-vs-planes comparison (``python -m
lsi_tpu_torch.evaluation.compare``, the counterpart of
``scripts/compare_ldi_mpi.py``) at toy widths on the CPU: both presets
train the same steps on the same scenes, and the one table it prints
holds, row by row, ``evaluation.runner.evaluate`` of each trained network
on the same 8 held-out batches (seed 4242).
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads per process)
import contextlib
import dataclasses
import io

import numpy as np
import pytest

from lsi_tpu_torch.evaluation import compare
from lsi_tpu_torch.evaluation.runner import eval_data_config, evaluate

TOY = ["model.base_filters=8", "model.num_scales=2", "model.num_planes=4",
       "model.compute_dtype=float32", "data.height=16", "data.width=32",
       "data.batch_size=2"]


@pytest.fixture(scope="module")
def run():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        results = compare.main(["2", "multi", "--device", "cpu", "--set",
                                *TOY])
    return results, out.getvalue()


def table_rows(text):
    """{metric: (LDI, MPI)} from the printed table."""
    lines = text.splitlines()
    start = [i for i, ln in enumerate(lines) if ln.startswith("metric ")]
    assert len(start) == 1, "one table"
    rows = {}
    for ln in lines[start[0] + 1:]:
        name, a, b = ln.split()
        rows[name] = (float(a), float(b))
    return rows


def test_both_families_trained_the_same_steps_on_the_same_scenes(run):
    results, out = run
    cfgs = [results[name]["config"] for name, _ in compare.PRESETS]
    assert [c.model.family for c in cfgs] == ["ldi", "mpi"]
    assert all(c.train.max_steps == 2 for c in cfgs)
    assert all(c.data.synthetic_scene == "multi" for c in cfgs)
    # The same held-out stream: the same batches for both.
    assert eval_data_config(cfgs[0].data) == eval_data_config(cfgs[1].data)
    assert out.count("=== training") == 2


def test_table_rows_equal_evaluate_on_each_trained_net(run):
    results, out = run
    rows = table_rows(out)
    both = set(results["synthetic_sanity"]["metrics"]) & set(
        results["mpi_baseline"]["metrics"])
    assert set(rows) == both and {"psnr", "ssim", "abs_rel"} <= both
    for col, (name, _) in enumerate(compare.PRESETS):
        r = results[name]
        again = evaluate(r["config"], r["net"],
                         num_batches=compare.EVAL_BATCHES,
                         seed=compare.EVAL_SEED, device="cpu")
        for k in both:
            assert again[k] == r["metrics"][k], (name, k)
            np.testing.assert_allclose(rows[k][col], again[k], rtol=0,
                                       atol=5e-5, err_msg=f"{name} {k}")


def test_comparison_config_keeps_the_render_window_off():
    """The port's comparison config is the JAX script's
    (``scripts/compare_ldi_mpi.py``): on multi scenes it widens
    ``render.pallas_max_dy`` to 8 and leaves the route at the preset's
    "auto", so the window stays off unless ``render.use_pallas=on`` is
    set; on two-plane scenes the render config is the preset's."""
    from lsi_tpu.config import RenderConfig as JRenderConfig
    from lsi_tpu.config import get_config as jget_config
    for name, _ in compare.PRESETS:
        for scene in ("multi", "two_plane"):
            cfg = compare.comparison_config(name, 5, scene, TOY, "/nowhere")
            base = compare.build_config(name, TOY)
            jrender = jget_config(name).render
            if scene == "multi":
                jrender = dataclasses.replace(jrender, pallas_max_dy=8)
            assert isinstance(jrender, JRenderConfig)
            assert dataclasses.asdict(cfg.render) == dataclasses.asdict(
                jrender)
            assert cfg.render.use_pallas == base.render.use_pallas == "auto"
            assert cfg.train == dataclasses.replace(
                base.train, max_steps=5, log_every=50, eval_every=0,
                checkpoint_every=5, checkpoint_dir="/nowhere")
