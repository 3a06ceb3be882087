"""Rendering and the training steps with rays sharded over the ranks.

Port of ``raytracingtest_tpu/parallel/render_sharded.py``. The reference
shards rays over a mesh's "rays" axis with shard_map and psums the voxel
gradients; here each rank of a ``torch.distributed`` world
(``parallel/mesh.py``) runs its own contiguous shard of the rays
(``mesh.ray_sharding``) through the frames and steps already ported, and
the gradients, loss and residual are ``all_reduce``d (SUM), the loss
normalised by the global ray count. The octree and the parameters are
replicated: every rank holds them whole.

  * ``render_sharded``: the stackless frame of a shard (kernel
    ``esvo_stackless``, then shading); no communication.
  * ``make_train_step`` / ``make_train_step_brick``: the L2 step of the
    stackless frame / of the brick frame (kernel ``brick_trace``).
  * ``render_tile_sharded`` / ``make_train_step_tile``: the tile frame
    (kernels ``tile_candidates``, ``tile_walk``) over whole tiles a rank;
    the step's ``overlap_groups`` > 1 splits the rank's tiles into groups
    and starts each group's gradient ``all_reduce`` while the next group
    computes.

A step takes this rank's shard of the rays and the target, and the
optimizer is the caller's ``torch.optim`` optimizer over the trained
tensors of `params` (``InverseRenderer.init_params``'s Adam): the step sets
their ``.grad`` to the all-reduced gradients and steps it, in place, and
returns (params, opt_state, loss[, residual]). Every rank's parameters stay
equal.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from raytracingtest_tpu_torch import diff
from raytracingtest_tpu_torch.parallel.mesh import RayMesh, all_sum

PARAM_NAMES = ("albedo", "normal", "density")


def _apply(params, opt_state, grads):
    """Set the gradients of the tensors the optimizer holds and step it."""
    held = {id(p) for group in opt_state.param_groups for p in group["params"]}
    for name, g in zip(PARAM_NAMES, grads):
        if id(params[name]) in held:
            params[name].grad = g
    opt_state.step()


def _mean_share(mesh: RayMesh, img, target, n_rows=None):
    """This rank's share of the global L2 loss over equal shards: its mean
    divided by the world's size (the reference's sum / n_total); for a part
    of the rank's `n_rows` rows, scaled by the part's rows."""
    share = torch.mean((img - target) ** 2) / mesh.world
    if n_rows is not None and n_rows != img.shape[0]:
        share = share * (img.shape[0] / n_rows)
    return share


def _flat(tensors):
    """The float32 tensors flattened into one, for one collective."""
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat, like):
    """`flat` cut back into tensors shaped as `like`."""
    parts = torch.split(flat, [t.numel() for t in like])
    return tuple(p.view(t.shape) for p, t in zip(parts, like))


def _sharded_step(mesh, params, opt_state, loss_fn):
    """Value and gradients of this rank's share, summed over the ranks in
    one all_reduce, then the optimizer's step. Returns the loss."""
    loss, grads = diff._value_and_grads(
        loss_fn, *(params[name] for name in PARAM_NAMES))
    flat = all_sum(mesh, _flat((*grads, loss)))
    *grads, loss = _unflat(flat, (*grads, loss))
    _apply(params, opt_state, grads)
    return loss


def render_sharded(mesh: RayMesh, albedo, normal, density, svo, o, d, light_dir):
    """This rank's (n, 3) radiance of its shard of rays (n, 3), through the
    stackless frame (``diff.render_diff``). The shards' images concatenated
    in rank order are the one-device image."""
    return diff.render_diff(albedo, normal, density, svo, o, d, light_dir)


def make_train_step(mesh: RayMesh):
    """The sharded L2 step of the stackless frame: train_step(params,
    opt_state, svo, o, d, light_dir, target) -> (params, opt_state, loss),
    on this rank's shard of rays and target."""

    def train_step(params, opt_state, svo, o, d, light_dir, target):
        loss = _sharded_step(mesh, params, opt_state, lambda a, n, s: _mean_share(
            mesh, diff.render_diff(a, n, s, svo, o, d, light_dir), target))
        return params, opt_state, loss

    return train_step


def make_train_step_brick(mesh: RayMesh):
    """The sharded L2 step of the brick frame (the same hits as the
    stackless step): train_step(params, opt_state, bsvo, o, d, light_dir,
    target) -> (params, opt_state, loss)."""

    def train_step(params, opt_state, bsvo, o, d, light_dir, target):
        loss = _sharded_step(mesh, params, opt_state, lambda a, n, s: _mean_share(
            mesh, diff.render_diff_brick(a, n, s, bsvo, o, d, light_dir), target))
        return params, opt_state, loss

    return train_step


def render_tile_sharded(mesh: RayMesh, albedo, normal, density, tsvo, o, d,
                        corners, light_dir, k_max=96, fb_tiles=128, fb_k=256):
    """This rank's tiles through the tile frame: o, d (T, P, 3) and corners
    (T, 4, 3), its shard of whole tiles. Returns ((T * P, 3) radiance, this
    rank's residual count (1,)); no communication."""
    img, residual = diff.render_diff_tile(
        albedo, normal, density, tsvo, o, d, corners, light_dir, k_max=k_max,
        fb_tiles=fb_tiles, fb_k=fb_k)
    return img, residual.reshape(1)


def make_train_step_tile(mesh: RayMesh, k_max=96, fb_tiles=128, fb_k=256,
                         overlap_groups=1):
    """The sharded L2 step of the tile frame: train_step(params, opt_state,
    tsvo, o, d, corners, light_dir, target) -> (params, opt_state, loss,
    residual), on this rank's tiles and its (T * P, 3) tile-major target.
    residual is the all-reduced count of rays whose hits stayed cap-limited
    (0 in normal operation; training loops must surface it).

    overlap_groups > 1 (dividing the rank's tile count) walks the tiles in
    that many groups and starts each group's gradient all_reduce
    asynchronously as soon as its backward is done, while the next group
    computes; the groups' losses and gradients add up to the ungrouped ones
    (a disjoint split of the rays)."""
    budgets = dict(k_max=k_max, fb_tiles=fb_tiles, fb_k=fb_k)

    def train_step(params, opt_state, tsvo, o, d, corners, light_dir, target):
        T = o.shape[0]
        groups = overlap_groups if overlap_groups > 1 and T % overlap_groups == 0 else 1
        gsz, ppx = T // groups, target.shape[0] // T
        values = tuple(params[name] for name in PARAM_NAMES)
        parts, works = [], []
        for i in range(groups):
            ts = slice(i * gsz, (i + 1) * gsz)
            rs = slice(i * gsz * ppx, (i + 1) * gsz * ppx)

            def share(a, n, s, ts=ts, rs=rs):
                img, residual = diff.render_diff_tile(
                    a, n, s, tsvo, o[ts], d[ts], corners[ts], light_dir, **budgets)
                return _mean_share(mesh, img, target[rs], target.shape[0]), residual

            (li, ri), gi = diff._value_and_grads(share, *values)
            flat = _flat(gi)
            works.append(dist.all_reduce(flat, group=mesh.group, async_op=True))
            parts.append((li, ri, flat))
        for work in works:
            work.wait()
        loss, residual, flat = parts[0]
        for li, ri, fi in parts[1:]:
            loss, residual, flat = loss + li, residual + ri, flat + fi
        grads = _unflat(flat, values)
        loss = all_sum(mesh, loss.clone())
        residual = all_sum(mesh, residual.clone())
        _apply(params, opt_state, grads)
        return params, opt_state, loss, residual

    return train_step
