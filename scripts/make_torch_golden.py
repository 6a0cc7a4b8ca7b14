"""Write the golden fixture that holds the PyTorch port to the JAX numbers.

Runs the JAX package on the CPU at toy size (32x64, base_filters=8,
num_scales=2, float32 compute, batch 2): ``LSIModel.init`` ->
``predict_ldi`` -> ``render_forward``, and stores the weights (in
``lsi_tpu.api.LSIModel.save``'s format, so ``lsi_tpu_torch.api.LSIModel.load``
reads the file directly), the inputs and the outputs in one ``.npz``:

    params/<flax path>, __config__     the model
    image (2,32,64,3)  intrinsics (2,3,3)  pose (2,4,4)
    ldi_textures (2,2,32,64,3)  ldi_disparities (2,2,32,64,1)
    rgb (2,32,64,3)  disparity (2,32,64,1)  coverage (2,32,64,1)

``chip_smoke.py`` (on the GPU, without JAX) and ``tests/test_torch_api.py``
read it. Regenerate with:

    JAX_PLATFORMS=cpu python scripts/make_torch_golden.py
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           os.pardir, "tests", "data", "torch_golden_toy.npz")


def make_golden(seed: int = 0):
    import jax
    import jax.numpy as jnp

    from lsi_tpu.api import LSIModel, default_intrinsics
    from lsi_tpu.config import Config, ModelConfig
    from lsi_tpu.geometry import transforms
    from lsi_tpu.geometry.ldi import render_forward

    b, h, w = 2, 32, 64
    config = Config(model=ModelConfig(base_filters=8, num_scales=2,
                                      compute_dtype="float32"))
    model = LSIModel.init(jax.random.key(seed), config, h, w)

    rng = np.random.default_rng(seed)
    image = rng.uniform(size=(b, h, w, 3)).astype(np.float32)
    intrinsics = np.asarray(default_intrinsics(b, h, w))
    pose = np.concatenate([
        np.asarray(transforms.translation_pose([[-0.1, 0.0, 0.0]])),
        np.asarray(transforms.pose_from_euler(
            [0.0, 0.02, 0.0], [0.05, 0.0, 0.0]))[None]])

    ldi = model.predict_ldi(jnp.asarray(image), jnp.asarray(intrinsics))
    out = render_forward(ldi, jnp.asarray(pose),
                         zbuffer_scale=config.render.zbuffer_scale,
                         use_pallas="off")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.npz")
        model.save(path)
        with np.load(path) as saved:
            arrays = {k: saved[k] for k in saved.files}
    arrays.update(
        image=image, intrinsics=intrinsics, pose=pose,
        ldi_textures=np.asarray(ldi.textures),
        ldi_disparities=np.asarray(ldi.disparities),
        rgb=np.asarray(out["rgb"]), disparity=np.asarray(out["disparity"]),
        coverage=np.asarray(out["coverage"]))
    return arrays


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=DEFAULT_OUT)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    arrays = make_golden(args.seed)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {os.path.abspath(args.out)} "
          f"({os.path.getsize(args.out)} bytes, {len(arrays)} arrays)")


if __name__ == "__main__":
    main()
