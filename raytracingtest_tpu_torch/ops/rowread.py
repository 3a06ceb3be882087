"""Dynamic row reads from a resident int32 table.

Counterpart of ``scratch/r4_pallas.py``, whose four functions asked whether
a TPU kernel can read one row of a table at an index it learns at run time:
``dynrow`` (index from a scalar operand), ``dynrow2`` (index from a
prefetched scalar), ``dynrow3`` (index = min over a block of per-ray
cursors) and ``dynrow8`` (eight rows for eight per-tile indices). On a GPU
a block loads its own indices, so the scalar operand and the prefetched
scalar are one mode. One kernel, ``rowread`` of ``csrc/tile_walk.cu``,
serves the three modes, and one launch of it a batch of requests of one
mode; it is the primitive the tile walker stages its candidate rows with.
CUDA tensors launch the kernel, CPU tensors take the plain version
``table[idx]``. Indices are clipped to the table, in both.
"""

from __future__ import annotations

import ctypes

import torch

from raytracingtest_tpu_torch._build import tile_lib
from raytracingtest_tpu_torch._launch import Kernel

_I32 = torch.int32

MODE_SCALAR, MODE_MIN, MODE_ROWS = 0, 1, 2

# row indices one launch takes as arguments (csrc/tile_walk.cu's ROW_SCALARS)
SCALAR_BATCH = 8

# kernel launches made by this process
launches = 0

_ROWREAD = Kernel("rowread", tile_lib)
_Scalars = ctypes.c_int * SCALAR_BATCH


def _launch(table, mode, scalar, idx, n_out):
    """One launch for `n_out` requests of one mode: `scalar` an int or up to
    ``SCALAR_BATCH`` ints (``MODE_SCALAR``); `idx` (n_out,) int32
    (``MODE_ROWS``) or (n_out, m) int32 cursors (``MODE_MIN``)."""
    global launches
    device = table.device
    if table.dim() != 2 or table.numel() == 0:
        raise ValueError(f"table has shape {tuple(table.shape)}, expected (rows, cols)")
    rows, cols = table.shape
    specs = [("table", table, _I32, (rows, cols))]
    scalars, n_scalars, idx_ptr, n_idx = None, 0, 0, 0
    if mode == MODE_SCALAR:
        values = _as_ints(scalar)
        n_scalars = len(values)
        if not 1 <= n_scalars <= SCALAR_BATCH or n_scalars != n_out:
            raise ValueError(f"{n_scalars} scalar indices for {n_out} rows; a "
                             f"launch takes 1 to {SCALAR_BATCH}")
        scalars = _Scalars(*values)
    else:
        if idx is None or idx.numel() < 1 or n_out < 1:
            raise ValueError("no index given")
        n_idx = idx.numel()
        shape = (n_out,) if mode == MODE_ROWS else (n_out, n_idx // n_out)
        specs.append(("indices", idx, _I32, shape))
    _ROWREAD.check(device, specs)
    if idx is not None:
        idx_ptr = idx.data_ptr()
    out = torch.empty((n_out, cols), dtype=_I32, device=device)
    _ROWREAD(device, table.data_ptr(), rows, cols, mode, scalars, n_scalars,
             idx_ptr, n_idx, out.data_ptr(), n_out)
    launches += 1
    return out


def _as_ints(index) -> tuple:
    """A scalar index, or a list or tuple of them, as a tuple of ints."""
    if isinstance(index, (list, tuple)):
        return tuple(int(i) for i in index)
    return (int(index),)


def _clip(index: int, rows: int) -> int:
    return max(0, min(int(index), rows - 1))


def rowread_scalar(table, index):
    """Rows of `table` at indices that are arguments of the launch
    (``dynrow``, ``dynrow2``): `index` an int gives (1, cols); a sequence of
    up to ``SCALAR_BATCH`` ints gives one row each, from one launch."""
    values = _as_ints(index)
    if not 1 <= len(values) <= SCALAR_BATCH:
        raise ValueError(f"{len(values)} scalar indices; a call takes 1 to "
                         f"{SCALAR_BATCH}")
    if table.device.type == "cpu":
        return table[[_clip(i, table.shape[0]) for i in values]]
    return _launch(table, MODE_SCALAR, values, None, len(values))


def rowread_min(table, cursors):
    """(1, cols): the row at the minimum of the int32 `cursors` (any shape),
    reduced inside the block that reads the row (``dynrow3``)."""
    return rowread_min_batch(table, cursors.reshape(1, -1))


def rowread_min_batch(table, cursors):
    """(B, cols): for each row of the int32 `cursors` (B, m), the row of
    `table` at that row's minimum; one block a request, one launch."""
    if cursors.dim() != 2:
        raise ValueError(f"cursors have shape {tuple(cursors.shape)}, expected (B, m)")
    if table.device.type == "cpu":
        return table[cursors.amin(dim=1).clamp(0, table.shape[0] - 1).long()]
    return _launch(table, MODE_MIN, 0, cursors, cursors.shape[0])


def rowread_rows(table, idx):
    """(n, cols): rows `idx` (int32 (n,)) of `table`, one block a row, each
    block loading its own index (``dynrow8`` with n = 8)."""
    if table.device.type == "cpu":
        return table[idx.clamp(0, table.shape[0] - 1).long()]
    if idx.dim() != 1:
        idx = idx.reshape(-1)
    return _launch(table, MODE_ROWS, 0, idx, idx.shape[0])
