"""Height-sharded LDI rendering: each rank splats its own rows, and the
splat contributions that cross a shard boundary ride a halo exchange.

PyTorch counterpart of ``lsi_tpu/parallel/spatial.py``
(``render_forward_spatial``). Each rank of a space group holds one
horizontal band of the LDI (``hd = H / S`` rows; :func:`shard_ldi`). It
projects its rows in GLOBAL pixel coordinates, takes the soft z-buffer's
per-image shift as the max over the space group, and splats into a local
target padded by ``pad = max_dy + 2`` rows above and below through the
WINDOWED splat (``SplatFn`` with ``max_dy``, ``fold_h = hd``,
``base_offset = pad``, 0 on the first shard: :func:`shard_splat_args`):
the window bounds every source pixel's reach to
``[-max_dy, max_dy + 1]`` rows of its base row, so whatever leaves the
band lands in the halo. The halo strips go to the neighbours, which add
them to their own rows (the edge strips, outside the image, are dropped),
and only then is the composite normalised. The result equals the
single-device render with the same window
(``geometry.ldi.render_forward(..., use_pallas="on", pallas_max_dy=...)``),
whose splat inputs (``geometry.ldi.splat_inputs``) it builds for its rows.
The window is the same under either ``render.use_pallas`` route: a
height shard needs it whatever the route. ``splat_method="sort"`` takes
the deterministic splat (K1-D) for the shard's splat, as JAX's lax halo
render takes its sort path.

The exchange is differentiable (:class:`HaloExchange`: its backward sends
the cotangent strips back, as ``ppermute`` transposes), so the LDI
gradient is the windowed render's. The batch may also be sharded over the
plan's data axis; the two axes are independent.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from lsi_tpu_torch.geometry.ldi import (LDI, check_splat_method, composite,
                                        splat_inputs)
from lsi_tpu_torch.kernels.splat_cuda import SplatFn
from lsi_tpu_torch.parallel.mesh import ProcessPlan, batch_slice, send_recv
from lsi_tpu_torch.parallel.reduce import all_reduce


def shard_ldi(ldi: LDI, plan: ProcessPlan) -> LDI:
    """This rank's part of a global LDI: its data index's examples and its
    space index's band of rows. Raises ValueError where the height or the
    batch does not divide."""
    b, h = ldi.batch, ldi.height
    if h % plan.space:
        raise ValueError(f"image height {h} not divisible by {plan.space} "
                         "shards")
    hd = h // plan.space
    bs = batch_slice(b, plan)
    rows = slice(plan.space_rank * hd, (plan.space_rank + 1) * hd)
    return LDI(textures=ldi.textures[bs, :, rows],
               disparities=ldi.disparities[bs, :, rows],
               intrinsics=ldi.intrinsics[bs])


class HaloExchange(torch.autograd.Function):
    """``(top, bot) -> (from_prev, from_next)``: each rank sends its bottom
    halo strip to the next rank of the space group and its top strip to
    the previous one, and receives theirs; a rank with no neighbour on a
    side receives zeros there (the strips that leave the image are
    dropped). The backward sends the cotangents the reverse way."""

    @staticmethod
    def forward(ctx, top, bot, plan):
        ctx.plan = plan
        return _exchange(plan, to_prev=top.detach(), to_next=bot.detach())

    @staticmethod
    def backward(ctx, g_prev, g_next):
        # from_prev was the previous rank's bottom strip: its cotangent
        # goes back to that rank, and so on.
        g_top, g_bot = _exchange(ctx.plan, to_prev=g_prev.contiguous(),
                                 to_next=g_next.contiguous())
        return g_top, g_bot, None


def _exchange(plan: ProcessPlan, to_prev: torch.Tensor,
              to_next: torch.Tensor):
    """Send ``to_prev`` to space index k - 1 and ``to_next`` to k + 1;
    return (what k - 1 sent to its next, what k + 1 sent to its prev)."""
    k, s = plan.space_rank, plan.space
    from_prev = torch.zeros_like(to_next)
    from_next = torch.zeros_like(to_next)
    sends, recvs = [], []
    if k > 0:
        sends.append((k - 1, to_prev.contiguous()))
        recvs.append((k - 1, from_prev))
    if k < s - 1:
        sends.append((k + 1, to_next.contiguous()))
        recvs.append((k + 1, from_next))
    if sends:
        send_recv(plan, sends, recvs)
    return from_prev, from_next


def render_forward_spatial(ldi: LDI, pose_src2trg: torch.Tensor,
                           plan: ProcessPlan,
                           K_trg: Optional[torch.Tensor] = None,
                           zbuffer_scale: float = 50.0,
                           pallas_max_dy: int = 2,
                           splat_method: str = "scatter"):
    """Height-sharded ``geometry.ldi.render_forward(..., use_pallas="on",
    pallas_max_dy=pallas_max_dy)`` with halo exchange.

    Args:
      ldi: THIS rank's shard (:func:`shard_ldi`): (B_local, L, hd, W, ·)
        with ``hd = H / plan.space`` rows starting at global row
        ``plan.space_rank * hd``.
      pose_src2trg, K_trg: this rank's examples' (B_local, ...).
      pallas_max_dy: the splat's vertical window (JAX's name).
      splat_method: "scatter" (K1) or "sort" (K1-D, deterministic).
    Returns rgb (B_local, hd, W, 3), disparity and coverage (.., 1): this
    rank's rows of the windowed render.
    """
    hd = ldi.height
    deterministic = check_splat_method(splat_method)
    pad = pallas_max_dy + 2          # max vertical splat reach (+1 corner)
    if pad > hd:
        raise ValueError(
            f"halo pad {pad} exceeds shard height {hd}; use fewer shards "
            f"or a smaller pallas_max_dy")
    row0 = plan.space_rank * hd

    def space_max(t):
        return all_reduce(t.clone(), plan.space_group,
                          torch.distributed.ReduceOp.MAX)

    payload, coords, weights, out_hw, window = shard_splat_args(
        ldi, pose_src2trg, K_trg, zbuffer_scale, row0, pallas_max_dy,
        space_max)
    accum, wsum = SplatFn.apply(payload, coords, weights, out_hw, *window,
                                deterministic)
    out = torch.cat([accum, wsum], dim=-1)  # (B, hd + 2 pad, W, 5)
    off = window[2]
    mid, bot = out[:, off:off + hd], out[:, off + hd:off + hd + pad]
    # Shard 0's top strip lies above the image: it is never sent.
    top = out[:, off - pad:off] if off else torch.zeros_like(bot)
    from_prev, from_next = HaloExchange.apply(top, bot, plan)
    # Add the neighbours' strips to this band's first and last pad rows.
    mid = (mid + F.pad(from_prev, (0, 0, 0, 0, 0, hd - pad))
           + F.pad(from_next, (0, 0, 0, 0, hd - pad, 0)))
    # Normalise AFTER the exchange, as the single-device render does.
    return composite(mid[..., :4], mid[..., 4:])


def shard_splat_args(ldi: LDI, pose_src2trg: torch.Tensor,
                     K_trg: Optional[torch.Tensor], zbuffer_scale: float,
                     row0: int, max_dy: int,
                     global_max: Optional[Callable] = None):
    """The windowed splat of one shard (rows ``row0 .. row0 + hd`` of the
    image) into its local target: ``(payload, coords, weights, out_hw,
    (max_dy, hd, offset))``, the arguments of ``SplatFn`` in
    :func:`render_forward_spatial`.

    The local target holds ``hd + 2 pad`` rows starting at global row
    ``row0 - offset``: ``offset = pad`` above every shard but the first,
    whose top halo lies outside the image (``offset = 0``, no shift). The
    shift ``s = row0 - pad`` of the others is exact for every coordinate
    that can reach the target (y >= s - 1 >= s / 2 for s >= 2, so y - s
    needs no more bits than y; s = 1, a shard of pad + 1 rows, is the one
    exception), so the local splat sees the global render's fractions,
    snapped alike. (JAX shifts the first shard by -pad too, which rounds
    where y + pad crosses a power of two; PARITY.md.)
    """
    hd = ldi.height
    pad = max_dy + 2
    offset = pad if row0 else 0
    payload, tc, weights, _ = splat_inputs(ldi, pose_src2trg, K_trg,
                                           zbuffer_scale, row0, global_max)
    if row0 - offset:
        tc = (tc - torch.tensor([0.0, float(row0 - offset)],
                                device=tc.device)).contiguous()
    return (payload, tc, weights, (hd + 2 * pad, ldi.width),
            (max_dy, hd, offset))
