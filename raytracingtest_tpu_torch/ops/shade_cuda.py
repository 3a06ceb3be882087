"""Fused shading on the card, forward and backward: the wrappers of
``shade_fwd``, ``shade_bwd`` and ``segment_sum`` in ``csrc/shade.cu``.

Counterpart of ``gather_voxel_params`` with ``shade_diff`` in
``raytracingtest_tpu/diff.py`` and of the backward XLA derives for them.
``shade_fwd`` gathers a ray's parameter row from the three parameter tensors
and shades it in one kernel. The backward is two calls: ``shade_bwd`` turns
the image cotangent into the seven cotangents of each ray's row (a block's
rows staged in shared memory and moved as 16-byte vectors; its first form
``shade_bwd_serial``, every row moved by its ray's own thread word by word,
gives the same bits and is off the training path), and
``segment_sum`` adds each leaf's rows in ascending ray index from +0, the
order of a serial scatter-add, so the gradients are the same bits in every
run. It sorts nothing but the ray ids inside a leaf and uses integer atomics
only, on counts and cursors. ``ShadeCuda`` ties the three into one
``torch.autograd.Function``. ``sort_by_leaf`` with ``segment_sum_sorted`` is
the earlier form of the same sum (a stable sort of every ray by leaf id,
then one thread a run), kept as an independent implementation to hold the
new one against.

CUDA tensors launch the kernels; CPU tensors take the plain versions beside
them (``shade_rows`` on rows gathered by plain indexing, autograd through
it, and a serial scatter-add), built from the helpers the plain path of
``diff.py`` is built from (``safe_leaf``, ``index_rows``,
``scatter_add_rows``). Nothing else picks the path: a build or launch
failure raises.
"""

from __future__ import annotations

import torch

from raytracingtest_tpu_torch._build import shade_lib
from raytracingtest_tpu_torch._launch import Kernel
from raytracingtest_tpu_torch.render import sky_color

_F32, _I32, _I64 = torch.float32, torch.int32, torch.int64

# kernel launches made by this process, by kernel (a call of segment_sum
# counts once: its passes go out together)
launches = {"shade_fwd": 0, "shade_bwd": 0, "shade_bwd_serial": 0,
            "segment_sum": 0, "segment_sum_sorted": 0}

_SHADE_FWD = Kernel("shade_fwd", shade_lib)
_SHADE_BWD = Kernel("shade_bwd", shade_lib)
_SHADE_BWD_SERIAL = Kernel("shade_bwd_serial", shade_lib)
_SEGMENT_SUM = Kernel("segment_sum", shade_lib)
_SEGMENT_SUM_SORTED = Kernel("segment_sum_sorted", shade_lib)

# csrc/shade.cu's SEG_SHORT: the longest run a leaf's own thread adds; longer
# ones go to a block each
SEG_SHORT = 16


def _sum3(x):
    """(x0 + x1) + x2 over the last axis: the order the kernels add in."""
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def shade_rows(alb, nrm, den, hit, sky, light_dir, light_intensity,
               light_ambient):
    """Lambert shading of rays whose parameter rows are already gathered:
    `alb`, `nrm` (N, 3), `den` (N,), `hit` (N,) bool, `sky` (N, 3). Returns
    (N, 3) radiance, differentiable in the rows.

    max, min and clip are ``torch.maximum``/``torch.minimum`` against
    tensors: at a tie they pass half the gradient, as ``jnp.maximum`` and
    ``jnp.clip`` do, where ``torch.clamp`` passes all of it. Every default
    scene's density is exactly 1.0, a tie."""
    zero, one = den.new_zeros(()), den.new_ones(())
    ldir = light_dir / torch.sqrt(_sum3(light_dir * light_dir))
    # normalised through the graph, so a normal's gradient stays tangent
    floor = den.new_full((), 1e-12)
    nn = nrm / torch.sqrt(torch.maximum(_sum3(nrm * nrm), floor))[:, None]
    ndotl = torch.maximum(_sum3(nn * (-ldir)[None, :]), zero)
    lit = alb * (ndotl * light_intensity + light_ambient)[:, None]
    alpha = (torch.minimum(torch.maximum(den, zero), one) * hit)[:, None]
    return alpha * lit + (1.0 - alpha) * sky


def safe_leaf(hit_leaf, n_leaves):
    """(hit (N,) bool, leaf (N,) int64 in [0, n_leaves)): a miss reads leaf
    0; its `hit` of False zeroes what it reads."""
    hit = hit_leaf >= 0
    return hit, torch.where(hit, hit_leaf, 0).long().clamp(max=n_leaves - 1)


def index_rows(leaf_id, albedo, normal, density):
    """(alb (N, 3), nrm (N, 3), den (N,)): the parameter rows of the leaf
    ids, which lie in [0, n_leaves), by plain indexing."""
    leaf_id = leaf_id.long()
    return albedo[leaf_id], normal[leaf_id], density[leaf_id]


def scatter_add_rows(leaf_id, cols7, n_leaves):
    """The (n, 7) rows summed onto their leaves by seven rank-1
    scatter-adds; returns ((n_leaves, 3), (n_leaves, 3), (n_leaves,)). On
    the CPU a 1-D ``index_add_`` adds one row after another in index order:
    a serial scatter-add, and the order of builtin autograd's."""
    leaf_id = leaf_id.long()
    out = [cols7.new_zeros(n_leaves).index_add_(0, leaf_id, cols7[:, c])
           for c in range(7)]
    return torch.stack(out[0:3], dim=1), torch.stack(out[3:6], dim=1), out[6]


def _shade_specs(hit_leaf, d, albedo, normal, density, light_dir, sky):
    """(n rays, n leaves, what a shading kernel's launcher checks of its
    arguments)."""
    n, n_leaves = hit_leaf.shape[0], albedo.shape[0]
    if n_leaves < 1 or n >= 2 ** 31 // 7:
        raise ValueError(f"{n_leaves} leaves or {n} rays out of range")
    specs = [("hit_leaf", hit_leaf, _I32, (n,)), ("d", d, _F32, (n, 3)),
             ("albedo", albedo, _F32, (n_leaves, 3)),
             ("normal", normal, _F32, (n_leaves, 3)),
             ("density", density, _F32, (n_leaves,)),
             ("light_dir", light_dir, _F32, (3,))]
    if sky is not None:
        specs.append(("sky", sky, _F32, (n, 3)))
    return n, n_leaves, specs


def shade_fwd(hit_leaf, d, albedo, normal, density, light_dir,
              light_intensity, light_ambient, sky=None):
    """(N, 3) radiance of traced rays: `hit_leaf` (N,) int32 (negative: a
    miss), `d` (N, 3), the parameter tensors (n_leaves, 3), (n_leaves, 3),
    (n_leaves,) with n_leaves >= 1, `light_dir` (3,). `sky` (N, 3) is the
    miss colour; None means the procedural gradient, which the kernel
    computes itself."""
    if hit_leaf.device.type == "cpu":
        hit, leaf = safe_leaf(hit_leaf, albedo.shape[0])
        return shade_rows(*index_rows(leaf, albedo, normal, density), hit,
                          sky_color(d) if sky is None else sky, light_dir,
                          light_intensity, light_ambient)
    device = hit_leaf.device
    n, n_leaves, specs = _shade_specs(hit_leaf, d, albedo, normal, density,
                                      light_dir, sky)
    _SHADE_FWD.check(device, specs)
    out = torch.empty((n, 3), dtype=_F32, device=device)
    _SHADE_FWD(device, hit_leaf.data_ptr(), d.data_ptr(), albedo.data_ptr(),
               normal.data_ptr(), density.data_ptr(), n_leaves,
               light_dir.data_ptr(), float(light_intensity),
               float(light_ambient), 0 if sky is None else sky.data_ptr(),
               out.data_ptr(), n)
    launches["shade_fwd"] += 1
    return out


def shade_bwd_plain(g, hit_leaf, d, albedo, normal, density, light_dir,
                    light_intensity, light_ambient, sky=None):
    """The row cotangents by ``torch.autograd`` through ``shade_rows``, on
    any device."""
    hit, leaf = safe_leaf(hit_leaf, albedo.shape[0])
    rows = [t.detach().requires_grad_(True)
            for t in index_rows(leaf, albedo, normal, density)]
    with torch.enable_grad():
        img = shade_rows(*rows, hit, sky_color(d) if sky is None else sky,
                         light_dir, light_intensity, light_ambient)
        g_alb, g_nrm, g_den = torch.autograd.grad(img, rows, g)
    return torch.cat([g_alb, g_nrm, g_den[:, None]], dim=1)


def _bwd_kernel(kernel, g, hit_leaf, d, albedo, normal, density, light_dir,
                light_intensity, light_ambient, sky):
    """Launch one of the two backward kernels on CUDA tensors; returns cot."""
    device = hit_leaf.device
    n, n_leaves, specs = _shade_specs(hit_leaf, d, albedo, normal, density,
                                      light_dir, sky)
    specs.append(("g", g, _F32, (n, 3)))
    kernel.check(device, specs)
    cot = torch.empty((n, 7), dtype=_F32, device=device)
    kernel(device, g.data_ptr(), hit_leaf.data_ptr(), d.data_ptr(),
           albedo.data_ptr(), normal.data_ptr(), density.data_ptr(), n_leaves,
           light_dir.data_ptr(), float(light_intensity), float(light_ambient),
           0 if sky is None else sky.data_ptr(), cot.data_ptr(), n)
    launches[kernel.name] += 1
    return cot


def shade_bwd(g, hit_leaf, d, albedo, normal, density, light_dir,
              light_intensity, light_ambient, sky=None):
    """(N, 7) cotangents of each ray's parameter row (albedo 3, normal 3,
    density 1) from the image cotangent `g` (N, 3); the other arguments as
    ``shade_fwd``. Rows of misses are zero."""
    if hit_leaf.device.type == "cpu":
        return shade_bwd_plain(g, hit_leaf, d, albedo, normal, density,
                               light_dir, light_intensity, light_ambient, sky)
    return _bwd_kernel(_SHADE_BWD, g, hit_leaf, d, albedo, normal, density,
                       light_dir, light_intensity, light_ambient, sky)


def shade_bwd_serial(g, hit_leaf, d, albedo, normal, density, light_dir,
                     light_intensity, light_ambient, sky=None):
    """``shade_bwd`` through its first form, a thread a ray moving its rows
    word by word: the same bits. The kernel runs for CUDA tensors, the
    plain version for CPU tensors."""
    if hit_leaf.device.type == "cpu":
        return shade_bwd_plain(g, hit_leaf, d, albedo, normal, density,
                               light_dir, light_intensity, light_ambient, sky)
    return _bwd_kernel(_SHADE_BWD_SERIAL, g, hit_leaf, d, albedo, normal,
                       density, light_dir, light_intensity, light_ambient, sky)


def segment_scratch_words(n, n_leaves):
    """The int32 words of scratch ``segment_sum``'s kernels use for `n` rays
    and `n_leaves` leaves: a count and a cursor a leaf, two counters, a slot a
    ray, and the list of leaves with runs above ``SEG_SHORT``."""
    return 2 * n_leaves + 2 + n + n // (SEG_SHORT + 1) + 1


def segment_sum(cot, hit_leaf, n_leaves):
    """Per-leaf sums of the (N, 7) cotangent rows `cot` onto the leaves
    `hit_leaf` (N,) int32 names: each leaf's rows are added one after another
    in ascending ray index, starting from +0, so the result is that of a
    serial scatter-add in ray order, bit for bit and in every run. A miss
    (`hit_leaf` < 0) adds nothing; an id above ``n_leaves - 1`` counts as
    that. Returns (g_albedo (n_leaves, 3), g_normal (n_leaves, 3), g_density
    (n_leaves,)); leaves that no ray hit are +0."""
    if cot.device.type == "cpu":
        hit = hit_leaf >= 0
        return scatter_add_rows(hit_leaf[hit].clamp(max=n_leaves - 1),
                                cot[hit], n_leaves)
    device, n = cot.device, cot.shape[0]
    if n_leaves < 1 or n >= 2 ** 31 // 7 or n_leaves >= 2 ** 31 // 7:
        raise ValueError(f"{n_leaves} leaves or {n} rows out of range")
    _SEGMENT_SUM.check(device, (("cot", cot, _F32, (n, 7)),
                                ("hit_leaf", hit_leaf, _I32, (n,))))
    words = segment_scratch_words(n, n_leaves)
    scratch = torch.empty(words, dtype=_I32, device=device)
    g_alb = torch.empty((n_leaves, 3), dtype=_F32, device=device)
    g_nrm = torch.empty((n_leaves, 3), dtype=_F32, device=device)
    g_den = torch.empty(n_leaves, dtype=_F32, device=device)
    _SEGMENT_SUM(device, hit_leaf.data_ptr(), cot.data_ptr(), n, n_leaves,
                 scratch.data_ptr(), words, g_alb.data_ptr(),
                 g_nrm.data_ptr(), g_den.data_ptr())
    launches["segment_sum"] += 1
    return g_alb, g_nrm, g_den


def sort_by_leaf(hit_leaf, n_leaves):
    """(keys, order): the rays in ascending leaf id, rays of one leaf in ray
    order (a stable sort). A miss gets the key `n_leaves`, which sorts behind
    every leaf and which ``segment_sum_sorted`` never reads."""
    keys = torch.where(hit_leaf >= 0, hit_leaf.clamp(max=n_leaves - 1), n_leaves)
    keys, order = torch.sort(keys, stable=True)
    return keys, order


def segment_sum_sorted(cot, keys, order, n_leaves):
    """The sorted form of ``segment_sum``: `keys` (N,) int32 ascending leaf
    ids and `order` (N,) int64, as ``sort_by_leaf`` returns them. The thread
    at the head of each leaf's run adds the run's rows one after another in
    sorted (= ray) order, from +0: the same sums, bit for bit."""
    if cot.device.type == "cpu":
        valid = (keys >= 0) & (keys < n_leaves)
        return scatter_add_rows(keys[valid], cot[order[valid]], n_leaves)
    device, n = cot.device, cot.shape[0]
    if n_leaves < 1 or n >= 2 ** 31 // 7:
        raise ValueError(f"{n_leaves} leaves or {n} rows out of range")
    _SEGMENT_SUM_SORTED.check(device, (("cot", cot, _F32, (n, 7)),
                                       ("keys", keys, _I32, (n,)),
                                       ("order", order, _I64, (n,))))
    g_alb = torch.zeros((n_leaves, 3), dtype=_F32, device=device)
    g_nrm = torch.zeros((n_leaves, 3), dtype=_F32, device=device)
    g_den = torch.zeros(n_leaves, dtype=_F32, device=device)
    _SEGMENT_SUM_SORTED(device, cot.data_ptr(), keys.data_ptr(),
                        order.data_ptr(), n, n_leaves, g_alb.data_ptr(),
                        g_nrm.data_ptr(), g_den.data_ptr())
    launches["segment_sum_sorted"] += 1
    return g_alb, g_nrm, g_den


class ShadeCuda(torch.autograd.Function):
    """Shading as one differentiable function of the three parameter
    tensors: ``shade_fwd`` forward; ``shade_bwd`` and ``segment_sum``
    backward. The hits, the rays, the light and the sky get no gradient."""

    @staticmethod
    def forward(ctx, albedo, normal, density, hit_leaf, d, light_dir,
                light_intensity, light_ambient, sky):
        albedo, normal, density = (t.detach().contiguous()
                                   for t in (albedo, normal, density))
        d = d.contiguous()
        ctx.save_for_backward(albedo, normal, density, hit_leaf, d, light_dir,
                              sky)
        ctx.light = (light_intensity, light_ambient)
        return shade_fwd(hit_leaf, d, albedo, normal, density, light_dir,
                         light_intensity, light_ambient, sky)

    @staticmethod
    def backward(ctx, g):
        albedo, normal, density, hit_leaf, d, light_dir, sky = ctx.saved_tensors
        cot = shade_bwd(g.contiguous(), hit_leaf, d, albedo, normal, density,
                        light_dir, *ctx.light, sky)
        return (*segment_sum(cot, hit_leaf, albedo.shape[0]),
                None, None, None, None, None, None)
