"""lsi_tpu_torch — layered scene inference in PyTorch, with CUDA kernels.

The PyTorch/CUDA port of ``lsi_tpu``, module for module. ``lsi_tpu`` (JAX)
is the reference the port's tests hold it against. This package imports
``torch`` and nothing of ``lsi_tpu`` or JAX.

Public API (layouts as in the JAX package):
    predict_ldi(image, model) -> LDI   # image (B, H, W, 3) float in [0, 1]
    render(ldi, pose)  -> image        # novel-view RGB (B, H, W, 3)

with LDI textures (B, L, H, W, 3), disparities (B, L, H, W, 1),
intrinsics (B, 3, 3) and poses (B, 4, 4).
"""

# Lazy public API (PEP 562): importing the package loads nothing heavy.
_EXPORTS = {
    "predict_ldi": ("lsi_tpu_torch.api", "predict_ldi"),
    "render": ("lsi_tpu_torch.api", "render"),
    "LSIModel": ("lsi_tpu_torch.api", "LSIModel"),
    "LDI": ("lsi_tpu_torch.geometry.ldi", "LDI"),
    "Config": ("lsi_tpu_torch.config", "Config"),
    "RenderConfig": ("lsi_tpu_torch.config", "RenderConfig"),
    "ModelConfig": ("lsi_tpu_torch.config", "ModelConfig"),
}


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib

        module, attr = _EXPORTS[name]
        value = getattr(importlib.import_module(module), attr)
        globals()[name] = value  # cache: later lookups skip __getattr__
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
