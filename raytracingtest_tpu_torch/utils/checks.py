"""Runtime validation of the trace, the render and the gradients.

Port of ``raytracingtest_tpu/utils/checks.py``. Where the JAX package
instruments its compiled programs with checkify, these run the port's
main-path functions (the kernels on the card, the plain versions on the
CPU) and then test the same predicates with tensor reductions:

  * the trace: hit_leaf in [-1, n_leaves), hit_t finite, and >= 0 on a hit;
  * the shaded radiance finite;
  * every voxel-parameter gradient finite.

Each returns ``(err, result)`` as the JAX package's does; ``err.throw()``
raises with the first failed predicate's message:

    err, img = checked_render_diff(albedo, normal, density, svo, o, d, light)
    err.throw()
"""

from __future__ import annotations

from typing import Optional

import torch

from raytracingtest_tpu_torch import diff
from raytracingtest_tpu_torch.ops import brick_cuda, traverse_cuda


class CheckError:
    """The outcome of a checked call: the first failed predicate's message,
    or None when every predicate held."""

    def __init__(self, message: Optional[str] = None):
        self.message = message

    def get(self) -> Optional[str]:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise RuntimeError(self.message)


def _first_failure(checks) -> CheckError:
    """`checks`: (bool tensor, message) pairs, read back in one transfer."""
    ok = torch.stack([c.reshape(()) for c, _ in checks]).cpu()
    for passed, (_, message) in zip(ok.tolist(), checks):
        if not passed:
            return CheckError(message)
    return CheckError()


def _trace_checks(res, n_leaves):
    hit = res.hit_leaf >= 0
    return [
        (torch.all(res.hit_leaf >= -1), "traversal produced hit_leaf < -1"),
        (torch.all(res.hit_leaf < n_leaves),
         "traversal produced hit_leaf out of bounds"),
        (torch.all(torch.isfinite(res.hit_t)),
         "traversal produced non-finite hit_t"),
        (torch.all(torch.where(hit, res.hit_t, 0.0) >= 0.0),
         "traversal produced negative hit_t"),
    ]


def checked_trace(svo, o, d, n_leaves: Optional[int] = None):
    """The stackless trace (``brick_cuda.trace_stackless_cuda``) of (N, 3)
    rays, checked against `n_leaves` (None: the SVO's): returns (err,
    TraceResult)."""
    n_leaves = svo.n_leaves if n_leaves is None else n_leaves
    res = brick_cuda.trace_stackless_cuda(svo, o, d)
    return _first_failure(_trace_checks(res, n_leaves)), res


def checked_render_diff(albedo, normal, density, svo, o, d, light_dir):
    """The per-ray frame (``traverse_cuda.trace_cuda`` then
    ``diff.shade_diff``), its trace and its radiance checked: returns (err,
    (N, 3) radiance)."""
    with torch.no_grad():
        res = traverse_cuda.trace_cuda(svo, o, d)
    img = diff.shade_diff(res.hit_leaf, d, albedo, normal, density,
                          light_dir, 1.3, 0.08)
    checks = _trace_checks(res, albedo.shape[0])
    checks.append((torch.all(torch.isfinite(img)),
                   "shading produced non-finite radiance"))
    return _first_failure(checks), img


def checked_grads(albedo, normal, density, svo, o, d, light_dir, target):
    """The per-ray frame's L2 loss and its gradients
    (``diff.loss_and_grads_cuda``), every gradient entry checked finite:
    returns (err, (loss, grads))."""
    loss, grads = diff.loss_and_grads_cuda(albedo, normal, density, svo, o, d,
                                           light_dir, target)
    checks = [(torch.all(torch.isfinite(g)), "non-finite voxel-parameter gradient")
              for g in grads]
    return _first_failure(checks), (loss, grads)
