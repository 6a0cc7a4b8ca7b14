"""Frozen configuration tree: the same dataclasses and presets as
``lsi_tpu/config.py``, whose comments document each field.

The port keeps its own copy so that it runs where the JAX package is
absent (it imports nothing from ``lsi_tpu``). ``tests/test_torch_api.py``
holds the two copies equal field by field and preset by preset, and
``api.LSIModel`` reads and writes the same JSON, so a saved model
round-trips between the packages.

``build_config`` (a preset with dotted ``--set`` overrides, through a
copy of ``apply_override``) is what the training and eval CLIs read.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    family: str = "ldi"             # "ldi" | "mpi" (layered planes).
    num_layers: int = 2
    base_filters: int = 32
    num_scales: int = 5
    min_disparity: float = 0.01
    max_disparity: float = 1.0
    layer0_texture_from_input: bool = True
    deep_heads_stopgrad_trunk: bool = False  # deep heads on a detached trunk.
    compute_dtype: str = "bfloat16"  # conv compute dtype (params stay f32).
    ordering_floor: float = 0.2
    ordering_cap: float = 1.0
    num_planes: int = 16
    min_depth: float = 1.0
    max_depth: float = 100.0


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    zbuffer_scale: float = 50.0
    splat_method: str = "scatter"   # "sort": the deterministic splat (K1-D).
    use_pallas: str = "auto"        # "on": the TPU kernels' windowed route.
    pallas_max_dy: int = 2          # that route's vertical window, in rows.
    window_check: bool = True       # count and warn what the window drops.


@dataclasses.dataclass(frozen=True)
class LossConfig:
    photo_mode: str = "inverse_warp"
    min_over_layers: bool = True
    min_layer0_margin: float = 0.0
    candidate_radius: int = 0
    ssim_weight: float = 0.0
    smoothness_weight: float = 0.05
    edge_aware_smoothness: bool = True
    smoothness_edge_gate_deep: bool = True
    splat_weight: float = 1.0
    inverse_warp_weight: float = 1.0
    depth_supervision_weight: float = 0.0
    consistency_weight: float = 0.0
    symmetric: bool = False
    consistency_stop_target: bool = False
    consistency_disocc_only: bool = False
    consistency_anchor_weight: float = 0.0
    consistency_deep_only: bool = False
    consistency_ema_teacher: bool = False  # targets from an EMA teacher.
    consistency_ema_decay: float = 0.999
    photo_layer0_weight: float = 0.0  # + a layer-0-only inverse warp.
    consistency_stop_step: int = 0   # > 0: drop the pseudo-label from here.
    consistency_start_step: int = 0


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "synthetic"
    root: str = ""
    height: int = 256
    width: int = 768
    batch_size: int = 8
    augment: bool = True
    split: str = "all"
    val_fraction: float = 0.1
    shuffle_buffer: int = 512
    prefetch: int = 2
    kitti_pairs: str = "stereo"
    temporal_stride: int = 1
    synthetic_scene: str = "two_plane"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-4
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    max_steps: int = 100_000
    warmup_steps: int = 500
    lr_end_factor: float = 0.1
    decay_steps: int = 0
    grad_clip_norm: float = 10.0
    checkpoint_dir: str = "/tmp/lsi_tpu_ckpt"
    checkpoint_every: int = 2000
    max_to_keep: int = 5
    log_every: int = 100
    eval_every: int = 0
    eval_batches: int = 4
    drift_warn_threshold: float = 0.15
    seed: int = 0
    remat_decoder: bool = False
    profile_dir: str = ""
    stage_layer0_steps: int = 0
    freeze_layer0_step: int = 0
    save_best_params: bool = True
    freeze_layer0_from_best: bool = False
    freeze_fallback_live: bool = False
    collapse_rollback_threshold: float = 0.0
    collapse_max_rollbacks: int = 2
    skip_nonfinite_updates: bool = True


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = ModelConfig()
    render: RenderConfig = RenderConfig()
    loss: LossConfig = LossConfig()
    data: DataConfig = DataConfig()
    train: TrainConfig = TrainConfig()

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, raw: dict) -> "Config":
        """Inverse of ``dataclasses.asdict`` (the ``__config__`` JSON)."""
        return cls(model=ModelConfig(**raw["model"]),
                   render=RenderConfig(**raw["render"]),
                   loss=LossConfig(**raw["loss"]),
                   data=DataConfig(**raw["data"]),
                   train=TrainConfig(**raw["train"]))


_QUALITY_LOSS = dict(photo_mode="both", smoothness_weight=0.01,
                     symmetric=True, consistency_anchor_weight=0.5,
                     consistency_weight=0.5, consistency_stop_target=True,
                     consistency_disocc_only=True, consistency_deep_only=True,
                     consistency_start_step=500, min_layer0_margin=0.02)

PRESETS = {
    "synthetic_sanity": Config(
        model=ModelConfig(num_layers=2, base_filters=16, num_scales=4),
        render=RenderConfig(zbuffer_scale=30.0),
        loss=LossConfig(photo_mode="both", smoothness_weight=0.01),
        data=DataConfig(dataset="synthetic", height=128, width=256,
                        batch_size=8),
        train=TrainConfig(learning_rate=5e-4, warmup_steps=20,
                          max_steps=2000)),
    # The flagship serving configuration (BASELINE.json north star).
    "kitti_ldi2": Config(
        model=ModelConfig(num_layers=2),
        loss=LossConfig(photo_mode="inverse_warp"),
        data=DataConfig(dataset="kitti", height=256, width=768,
                        batch_size=1)),
    "kitti_ldi3_quality": Config(
        model=ModelConfig(num_layers=3, layer0_texture_from_input=False),
        render=RenderConfig(pallas_max_dy=8),
        loss=LossConfig(**_QUALITY_LOSS),
        data=DataConfig(dataset="kitti", height=256, width=768,
                        batch_size=8),
        train=TrainConfig(learning_rate=5e-4, warmup_steps=50,
                          eval_every=2000, freeze_layer0_step=50_000,
                          freeze_layer0_from_best=True)),
    "synthia_ldi2_splat": Config(
        model=ModelConfig(num_layers=2),
        loss=LossConfig(photo_mode="splat", depth_supervision_weight=0.1),
        data=DataConfig(dataset="synthia", height=256, width=768,
                        batch_size=8)),
    "kitti_ldi3_b16": Config(
        model=ModelConfig(num_layers=3, layer0_texture_from_input=False),
        loss=LossConfig(photo_mode="both"),
        data=DataConfig(dataset="kitti", height=256, width=768,
                        batch_size=16)),
    "highres_b64": Config(
        model=ModelConfig(num_layers=2),
        render=RenderConfig(splat_method="scatter"),
        loss=LossConfig(photo_mode="splat"),
        data=DataConfig(dataset="kitti", height=512, width=1536,
                        batch_size=64),
        train=TrainConfig(remat_decoder=True)),
    "synthetic_multi": Config(
        model=ModelConfig(num_layers=3, base_filters=16, num_scales=4,
                          layer0_texture_from_input=False),
        render=RenderConfig(zbuffer_scale=30.0, pallas_max_dy=8),
        loss=LossConfig(**_QUALITY_LOSS),
        data=DataConfig(dataset="synthetic", synthetic_scene="multi",
                        height=128, width=256, batch_size=8),
        train=TrainConfig(learning_rate=5e-4, warmup_steps=50,
                          max_steps=5000)),
    "mpi_baseline": Config(
        model=ModelConfig(family="mpi", num_planes=16, base_filters=16,
                          num_scales=4, min_depth=1.0, max_depth=100.0),
        loss=LossConfig(photo_mode="splat", smoothness_weight=0.01),
        data=DataConfig(dataset="synthetic", height=128, width=256,
                        batch_size=8),
        train=TrainConfig(learning_rate=5e-4, warmup_steps=20,
                          max_steps=2000)),
    "trajectory_sweep": Config(
        model=ModelConfig(num_layers=2),
        render=RenderConfig(pallas_max_dy=16),
        data=DataConfig(dataset="synthetic", height=256, width=768,
                        batch_size=1)),
}


def get_config(name: str) -> Config:
    if name not in PRESETS:
        raise KeyError(
            f"unknown config preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]


def apply_override(cfg, dotted: str):
    """Apply one 'a.b=value' override to a frozen dataclass tree (a copy
    of ``lsi_tpu/train/__main__.py``'s, which would import JAX)."""
    path, value = dotted.split("=", 1)
    keys = path.split(".")

    def convert(old, s: str):
        if isinstance(old, bool):
            return s.lower() in ("1", "true", "yes")
        if isinstance(old, int):
            return int(s)
        if isinstance(old, float):
            return float(s)
        return s

    def rec(node, keys):
        if len(keys) == 1:
            old = getattr(node, keys[0])
            return dataclasses.replace(node, **{keys[0]: convert(old, value)})
        sub = getattr(node, keys[0])
        return dataclasses.replace(node, **{keys[0]: rec(sub, keys[1:])})

    return rec(cfg, keys)


def build_config(name: str, overrides) -> Config:
    """The preset ``name`` with each 'a.b=value' override applied (the
    training and eval CLIs' ``--config`` and ``--set``)."""
    cfg = get_config(name)
    for ov in overrides:
        cfg = apply_override(cfg, ov)
    return cfg
