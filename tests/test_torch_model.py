"""The port's UNet and LDIPredictor vs the Flax modules with the same
(converted) weights, and the weight converter itself.

Toy size: 32x64, base_filters=8, num_scales=2, batch 2. float32 compute
is compared tightly (1e-5: the same convolutions summed in another order);
bfloat16 loosely (2e-2: the two frameworks round to bf16 at other places).
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads per process)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsi_tpu.api import default_intrinsics as j_default_intrinsics
from lsi_tpu.config import ModelConfig as JModelConfig
from lsi_tpu.models.ldi_predictor import LDIPredictor as JLDIPredictor
from lsi_tpu.models.unet import UNet as JUNet
from lsi_tpu_torch.config import ModelConfig, get_config
from lsi_tpu_torch.models import convert
from lsi_tpu_torch.models.ldi_predictor import LDIPredictor
from lsi_tpu_torch.models.unet import UNet

H, W = 32, 64
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def flat_params(params):
    """Flax param tree -> {'a/b/c': np.ndarray} (the export's key format)."""
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def jax_model(cfg: ModelConfig, seed=0):
    jcfg = JModelConfig(**dataclasses.asdict(cfg))
    net = JLDIPredictor(jcfg)
    params = net.init(jax.random.key(seed), jnp.zeros((1, H, W, 3)),
                      j_default_intrinsics(1, H, W))["params"]
    return net, params


def torch_model(cfg: ModelConfig, params) -> LDIPredictor:
    net = LDIPredictor(cfg)
    net.load_state_dict(convert.state_dict_from_jax(flat_params(params), cfg))
    return net.eval()


def image_batch(rng, b=2):
    return rng.uniform(size=(b, H, W, 3)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unet_matches_flax(rng, dtype):
    """Covers the stride-2 SAME padding (0, 1), the flipped transposed-conv
    kernel and GroupNorm's eps 1e-6 / float32 statistics."""
    jdt = jnp.dtype(dtype)
    junet = JUNet(base_filters=8, num_scales=2, dtype=jdt)
    x = rng.uniform(-1, 1, (2, H, W, 3)).astype(np.float32)
    params = junet.init(jax.random.key(1), jnp.zeros((1, H, W, 3)))["params"]
    ref = np.asarray(junet.apply({"params": params}, jnp.asarray(x)),
                     np.float32)
    unet = UNet(3, 8, 2, getattr(torch, dtype))
    unet.load_state_dict({convert.torch_name(k): convert.to_torch(v, k)
                          for k, v in flat_params(params).items()})
    with torch.no_grad():
        got = unet(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.float().permute(0, 2, 3, 1).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL[dtype] * scale)


@pytest.mark.parametrize("layer0_from_input", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_predictor_matches_flax(rng, dtype, layer0_from_input):
    cfg = ModelConfig(base_filters=8, num_scales=2, compute_dtype=dtype,
                      layer0_texture_from_input=layer0_from_input,
                      ordering_cap=0.9)
    jnet, params = jax_model(cfg)
    img = image_batch(rng)
    K = np.array(j_default_intrinsics(2, H, W))
    ref = jnet.apply({"params": params}, jnp.asarray(img), jnp.asarray(K))
    with torch.no_grad():
        got = torch_model(cfg, params)(torch.from_numpy(img),
                                       torch.from_numpy(K))
    for name in ("textures", "disparities", "intrinsics"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=0, atol=TOL[dtype], err_msg=name)
    assert got.textures.shape == (2, 2, H, W, 3)
    assert got.disparities.shape == (2, 2, H, W, 1)


def test_param_count_matches_flax_at_flagship_width():
    """kitti_ldi2 (L=2, base_filters=32, num_scales=5): 7,107,941 params."""
    cfg = get_config("kitti_ldi2").model
    shapes = jax.eval_shape(
        lambda: JLDIPredictor(JModelConfig(**dataclasses.asdict(cfg))).init(
            jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
            j_default_intrinsics(1, 64, 64)))["params"]
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    with torch.device("meta"):
        n_torch = sum(p.numel() for p in LDIPredictor(cfg).parameters())
    assert n_jax == n_torch == 7_107_941


def test_converter_round_trip_and_export_format(tmp_path):
    """state_dict -> Flax paths -> state_dict is the identity, and the
    checkpoint export format (bare keys + __meta_*) converts too."""
    from lsi_tpu.train.checkpoint import export_params_npz

    cfg = ModelConfig(base_filters=8, num_scales=2)
    _, params = jax_model(cfg)
    flat = flat_params(params)
    assert set(convert.jax_from_state_dict(
        convert.state_dict_from_jax(flat, cfg))) == set(flat)
    for k, v in convert.jax_from_state_dict(
            convert.state_dict_from_jax(flat, cfg)).items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)

    path = tmp_path / "export.npz"
    export_params_npz(params, str(path), meta={"step": 7})
    with np.load(path) as data:
        sd = convert.state_dict_from_jax(dict(data), cfg)
    ref = convert.state_dict_from_jax(flat, cfg)
    assert all(torch.equal(sd[k], ref[k]) for k in ref)


@pytest.mark.parametrize("fault", ["missing", "left_over", "shape"])
def test_converter_rejects_mismatched_weights(fault):
    cfg = ModelConfig(base_filters=8, num_scales=2)
    flat = flat_params(jax_model(cfg)[1])
    if fault == "missing":
        del flat["disp_head/bias"]
    elif fault == "left_over":
        flat["UNet_0/enc9a/Conv_0/kernel"] = np.zeros((3, 3, 8, 8))
    else:
        flat["disp_head/bias"] = np.zeros(3, np.float32)
    with pytest.raises((KeyError, ValueError)):
        convert.state_dict_from_jax(flat, cfg)


def test_unported_model_options_raise():
    """The refuted ``deep_heads_stopgrad_trunk`` raises; an MPI config is
    the other family's (``models.build_model`` dispatches; see
    tests/test_torch_mpi.py), so the LDI predictor rejects it."""
    with pytest.raises(NotImplementedError):
        LDIPredictor(ModelConfig(deep_heads_stopgrad_trunk=True))
    with pytest.raises(ValueError):
        LDIPredictor(ModelConfig(family="mpi"))


def test_init_is_seeded():
    cfg = ModelConfig(base_filters=8, num_scales=2)

    def draw(seed):
        net = LDIPredictor(cfg)
        net.reset_parameters(torch.Generator().manual_seed(seed))
        return torch.cat([p.flatten() for p in net.parameters()])

    a, b, c = draw(0), draw(0), draw(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # lecun-normal: the first conv (fan_in 27) has std ~ sqrt(1/27).
    w = LDIPredictor(cfg)
    w.reset_parameters(torch.Generator().manual_seed(0))
    std = float(w.unet.enc0a.conv.weight.detach().std())
    assert 0.7 * 27 ** -0.5 < std < 1.3 * 27 ** -0.5
