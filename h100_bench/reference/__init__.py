"""The plain reference the benchmark holds the port against.

Plain PyTorch (and NumPy-free) copies of the port's CPU paths, frozen
here so that a change to ``lsi_tpu_torch`` cannot move the yardstick.
It imports neither ``jax`` nor ``lsi_tpu`` nor ``lsi_tpu_torch``; it
takes configuration values as plain dicts (``configs/<name>.json``) and
parameters as a ``{name: tensor}`` dict the benchmark made from the seed.

Copied from the tree at commit ee70f4d:

* ``geometry.py``: ``lsi_tpu_torch/geometry/transforms.py`` (the pose
  helpers and ``camera_trajectory``), ``geometry/projection.py``
  (``forward_project``), ``utils/helpers.py`` (``divide_safe``),
  ``ops/splat.py`` (``snap_fraction``, ``corner_contributions``,
  ``splat_bilinear`` scatter), ``ops/gather.py`` (``bilinear_sample``),
  ``geometry/ldi.py`` (``splat_inputs``, ``composite``,
  ``window_dropped_fraction``, ``render_forward``,
  ``project_layers_folded``), ``evaluation/occlusion.py``
  (``disocclusion_mask``) and ``evaluation/trajectory.py`` (the canonical
  sweep), with ``SplatFn``/``GatherFn`` replaced by autograd through the
  plain functions (what those do on the CPU);
* ``net.py``: ``models/unet.py`` and ``models/ldi_predictor.py`` (the
  forward pass), as functions of a parameter dict;
* ``losses.py``: ``losses/losses.py`` (the LDI terms, ``total_loss``,
  ``total_loss_bidirectional``) and ``evaluation/metrics.py`` (``ssim``);
* ``optim.py``: ``train/trainer.py`` (``make_lr_schedule``,
  ``Optimizer``, ``global_norm``) and the two-prediction
  ``loss_and_grads``.

``precision.py`` says in which precision each part runs: float32 (TF32
off) for the reference, lower for the control.
"""
