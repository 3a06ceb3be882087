"""Checkpoints: SVOs, the raw ESVO descriptor dump, and the fit's state.

Port of ``raytracingtest_tpu/io/checkpoint.py``, in its file layouts, so
either package reads what the other wrote:

  * ``save_svo``/``load_svo``: the SVO's arrays and layout in an npz;
  * ``save_esvo_binary``/``load_esvo_binary``: the reference's wire format
    (a header, then one int32 16|8|8 descriptor a node with relative child
    pointers), byte for byte the JAX package's;
  * ``save_train_state``/``load_train_state``: the voxel parameters under
    ``params/<name>`` in the JAX package's flattened npz layout, a ``step``,
    and a json sidecar of metadata.

The optimizer state is the port's own: a ``torch.optim.Adam``'s ``step``,
``exp_avg`` and ``exp_avg_sq`` of each trained tensor, under
``opt/torch/...`` keys, which the JAX package ignores. Optax's Adam state is
not mapped to torch's in either direction: a file of the other package
gives its parameters and no optimizer state.
"""

from __future__ import annotations

import json
import struct
import types

import numpy as np
import torch

from raytracingtest_tpu_torch._device import resolve
from raytracingtest_tpu_torch.convert import svo_from_numpy
from raytracingtest_tpu_torch.ops import codecs
from raytracingtest_tpu_torch.ops.octree import SVO

_MAGIC = b"RTT1"
# the Adam state's keys: the trained parameters' names in the optimizer's
# order, and each one's three entries
_OPT_NAMES = "opt/torch/__names__"
_ADAM_FIELDS = ("step", "exp_avg", "exp_avg_sq")


def save_esvo_binary(svo: SVO, path: str) -> None:
    """Raw ESVO descriptor dump: a header (magic, depth, n_nodes,
    level_start) then one little-endian int32 a node in the reference's
    16|8|8 format."""
    packed = codecs.pack_esvo_descriptors(svo)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<ii", svo.depth, packed.shape[0]))
        f.write(struct.pack(f"<{len(svo.level_start)}i", *svo.level_start))
        f.write(packed.astype("<i4").tobytes())


def load_esvo_binary(path: str):
    """A raw ESVO dump -> (masks, child_base, leaf_base, depth,
    level_start), int32 numpy arrays. The format holds no attributes."""
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != _MAGIC:
            raise ValueError(f"bad magic {magic!r}")
        depth, n_nodes = struct.unpack("<ii", f.read(8))
        level_start = struct.unpack(f"<{depth + 1}i", f.read(4 * (depth + 1)))
        packed = np.frombuffer(f.read(4 * n_nodes), dtype="<i4").astype(np.int32)
    masks, child_base, leaf_base = codecs.unpack_esvo_descriptors(
        packed, level_start, depth)
    return masks, child_base, leaf_base, depth, tuple(level_start)


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


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _flatten(tree, prefix=""):
    """The JAX package's flattened layout: nested dictionaries as
    "/"-joined keys, a list or tuple as its items under "<i>/" and a
    "__seq__" entry of (length, is_tuple)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        out[f"{prefix}__seq__"] = np.asarray(
            [len(tree), 1 if isinstance(tree, tuple) else 0])
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = _host(tree)
    return out


def _unflatten(flat, prefix=""):
    seq_key = f"{prefix}__seq__"
    if seq_key in flat:
        n, is_tuple = (int(v) for v in flat[seq_key])
        items = [_unflatten(flat, f"{prefix}{i}/") for i in range(n)]
        return tuple(items) if is_tuple else items
    direct = prefix.rstrip("/")
    if direct in flat:
        return flat[direct]
    keys = {k[len(prefix):].split("/")[0]
            for k in flat if k.startswith(prefix) and k != seq_key}
    return {k: _unflatten(flat, f"{prefix}{k}/") for k in sorted(keys)}


def _trained_names(params, opt_state):
    """The names of `params` whose tensors `opt_state` trains, in its
    order."""
    names = {id(v): k for k, v in params.items()}
    held = [p for group in opt_state.param_groups for p in group["params"]]
    if any(id(p) not in names for p in held):
        raise ValueError("the optimizer trains a tensor that is not in params")
    return [names[id(p)] for p in held]


def save_train_state(path: str, params, opt_state=None, step: int = 0,
                     meta: dict | None = None) -> None:
    """Checkpoint a fit: `params` (a dictionary of tensors or arrays) under
    ``params/<name>``, the Adam state of `opt_state` (a torch.optim.Adam
    over tensors of `params`, or None) under ``opt/torch/<name>/<field>``,
    `step`, and ``<path>.meta.json`` with `step` and `meta`."""
    flat = _flatten({"params": params})
    if opt_state is not None:
        names = _trained_names(params, opt_state)
        flat[_OPT_NAMES] = np.asarray(names)
        for name in names:
            state = opt_state.state.get(params[name], {})
            for field in _ADAM_FIELDS:
                if field in state:
                    flat[f"opt/torch/{name}/{field}"] = _host(state[field])
    flat["step"] = np.asarray(step)
    np.savez_compressed(path, **flat)
    with open(path + ".meta.json", "w") as f:
        json.dump({"step": step, **(meta or {})}, f)


def load_train_state(path: str, opt_state_template=None, device=None):
    """(params, opt_state, step) from a checkpoint of either package.

    `params` is a dictionary of float tensors on `device` (None: the
    default device). With `opt_state_template`, a torch.optim.Adam such as
    ``InverseRenderer.init_params`` returns, and a file that holds the
    port's Adam state: each trained tensor of the template takes the
    file's values in place, the template takes the file's Adam state, and
    `params` holds the template's tensors for those names, so the optimizer
    goes on training them. Otherwise `opt_state` is None."""
    device = resolve(device)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    params = {k: torch.as_tensor(v, device=device)
              for k, v in _unflatten(flat, "params/").items()}
    step = int(flat["step"])
    if opt_state_template is None or _OPT_NAMES not in flat:
        return params, None, step
    names = [str(n) for n in flat[_OPT_NAMES]]
    held = [p for group in opt_state_template.param_groups for p in group["params"]]
    if len(held) != len(names):
        raise ValueError(f"the template trains {len(held)} tensors, the file "
                         f"{len(names)} ({names})")
    state = {}
    with torch.no_grad():
        for i, (name, p) in enumerate(zip(names, held)):
            p.copy_(params[name])
            params[name] = p
            fields = {f: torch.as_tensor(flat[f"opt/torch/{name}/{f}"])
                      for f in _ADAM_FIELDS if f"opt/torch/{name}/{f}" in flat}
            if fields:
                state[i] = fields
    saved = opt_state_template.state_dict()
    opt_state_template.load_state_dict(
        {"state": state, "param_groups": saved["param_groups"]})
    return params, opt_state_template, step
