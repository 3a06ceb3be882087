"""Move the JAX package's state into the port.

The functions take numpy-convertible arrays (a JAX-built SVO, a loaded
npz, plain numpy), so the port and the reference can run on identical
state. Nothing here imports the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracingtest_tpu_torch._device import resolve
from raytracingtest_tpu_torch.ops.brick import BrickSVO, _words
from raytracingtest_tpu_torch.ops.octree import SVO
from raytracingtest_tpu_torch.ops.tile import TileSVO

_INT_FIELDS = ("masks", "child_base", "leaf_base")
_FLOAT_FIELDS = ("leaf_albedo", "leaf_normal", "leaf_density")


def _tensor(a, dtype, device):
    # np.array copies: JAX hands out read-only buffers
    return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(device)


def svo_from_numpy(obj, device=None) -> SVO:
    """The port's SVO on `device` (None: the default device) from any object with the JAX SVO's fields
    (masks, child_base, leaf_base, leaf_albedo, leaf_normal, leaf_density,
    depth, level_start, optional parent_ptr) as numpy-convertible arrays."""
    device = resolve(device)
    fields = {name: _tensor(getattr(obj, name), np.int32, device)
              for name in _INT_FIELDS}
    fields.update({name: _tensor(getattr(obj, name), np.float32, device)
                   for name in _FLOAT_FIELDS})
    pptr = getattr(obj, "parent_ptr", None)
    return SVO(**fields, depth=int(obj.depth),
               level_start=tuple(int(v) for v in obj.level_start),
               parent_ptr=None if pptr is None else _tensor(pptr, np.int32, device))


def params_from_numpy(albedo, normal, density, device=None):
    """Voxel parameters (albedo (n,3), normal (n,3), density (n,)) as
    float32 tensors on `device` (None: the default device)."""
    device = resolve(device)
    return tuple(_tensor(a, np.float32, device)
                 for a in (albedo, normal, density))


def train_params_from_numpy(params, device=None):
    """The reference's parameter pytree ({"albedo", "normal", "density"} of
    numpy-convertible arrays) as the port's parameter dictionary on
    `device` (None: the default device)."""
    albedo, normal, density = params_from_numpy(
        params["albedo"], params["normal"], params["density"], device)
    return {"albedo": albedo, "normal": normal, "density": density}


def brick_svo_from_numpy(obj, device=None) -> BrickSVO:
    """The port's BrickSVO on `device` (None: the default device) from any
    object with the JAX BrickSVO's fields; the uint32 brick words are
    carried as int32 bit patterns."""
    device = resolve(device)
    return BrickSVO(
        top_masks=_tensor(obj.top_masks, np.int32, device),
        top_child=_tensor(obj.top_child, np.int32, device),
        top_parent=_tensor(obj.top_parent, np.int32, device),
        bricks=_words(np.asarray(obj.bricks)).to(device),
        depth=int(obj.depth), top_depth=int(obj.top_depth))


def tile_svo_from_numpy(obj, device=None) -> TileSVO:
    """The port's TileSVO on `device` (None: the default device) from any
    object with the JAX TileSVO's fields (bsvo, pyr, cellmap)."""
    device = resolve(device)
    return TileSVO(bsvo=brick_svo_from_numpy(obj.bsvo, device),
                   pyr=_words(np.asarray(obj.pyr)).to(device),
                   cellmap=_tensor(obj.cellmap, np.int32, device))


def attachments_from_numpy(word_a, word_b, device=None):
    """The reference's 64-bit node attachments (two uint32 words a node, as
    its ``codecs.build_attachments`` returns them) as the int32 tensors of
    the same bits that ``render.render_attachment`` reads, on `device`
    (None: the default device)."""
    device = resolve(device)
    return (_words(np.asarray(word_a)).to(device),
            _words(np.asarray(word_b)).to(device))
