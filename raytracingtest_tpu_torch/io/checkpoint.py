"""SVO checkpoints: the JAX package's npz layout (``io/checkpoint.py``
save_svo/load_svo), so either package reads what the other wrote."""

from __future__ import annotations

import types

import numpy as np

from raytracingtest_tpu_torch.convert import svo_from_numpy
from raytracingtest_tpu_torch.ops.octree import SVO


def save_svo(svo: SVO, path: str) -> None:
    np.savez_compressed(
        path,
        masks=svo.masks.cpu().numpy(),
        child_base=svo.child_base.cpu().numpy(),
        leaf_base=svo.leaf_base.cpu().numpy(),
        leaf_albedo=svo.leaf_albedo.cpu().numpy(),
        leaf_normal=svo.leaf_normal.cpu().numpy(),
        leaf_density=svo.leaf_density.cpu().numpy(),
        depth=np.int32(svo.depth),
        level_start=np.asarray(svo.level_start, np.int64),
    )


def load_svo(path: str, device=None) -> SVO:
    """Load an npz checkpoint onto `device` (None: the default device);
    parent_ptr is not stored."""
    with np.load(path) as z:
        fields = {k: z[k] for k in z.files}
    return svo_from_numpy(types.SimpleNamespace(**fields), device)
