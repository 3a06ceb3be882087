"""Dynamic row reads from a resident int32 table.

Counterpart of ``scratch/r4_pallas.py``, whose four functions asked whether
a TPU kernel can read one row of a table at an index it learns at run time:
``dynrow`` (index from a scalar operand), ``dynrow2`` (index from a
prefetched scalar), ``dynrow3`` (index = min over a block of per-ray
cursors) and ``dynrow8`` (eight rows for eight per-tile indices). On a GPU
a block loads its own indices, so the scalar operand and the prefetched
scalar are one mode. One kernel, ``rowread`` of ``csrc/tile_walk.cu``,
serves the three modes; it is the primitive the tile walker stages its
candidate rows with. CUDA tensors launch the kernel, CPU tensors take the
plain version ``table[idx]``. Indices are clipped to the table, in both.
"""

from __future__ import annotations

import torch

from raytracingtest_tpu_torch._device import check_tensor

_I32 = torch.int32

MODE_SCALAR, MODE_MIN, MODE_ROWS = 0, 1, 2

# kernel launches made by this process
launches = 0


def _launch(table, mode, scalar, idx, n_out):
    global launches
    device = table.device
    if device.type != "cuda":
        raise ValueError(f"the row-read kernel takes CUDA tensors, got {device}")
    if table.dim() != 2 or table.numel() == 0:
        raise ValueError(f"table has shape {tuple(table.shape)}, expected (rows, cols)")
    check_tensor("table", table, _I32, table.shape, device)
    rows, cols = table.shape
    n_idx = 0
    if idx is not None:
        n_idx = idx.numel()
        if n_idx < 1:
            raise ValueError("no index given")
        check_tensor("indices", idx, _I32, (n_idx,), device)

    from raytracingtest_tpu_torch._build import tile_lib

    lib = tile_lib()
    out = torch.empty((n_out, cols), dtype=_I32, device=device)
    with torch.cuda.device(device):
        err = lib.rowread(
            table.data_ptr(), rows, cols, mode, int(scalar),
            0 if idx is None else idx.data_ptr(), n_idx, out.data_ptr(),
            n_out, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rowread launch failed: cudaError {err}")
    launches += 1
    return out


def rowread_scalar(table, index: int):
    """(1, cols): row `index` of `table`, the index a scalar argument of the
    launch (``dynrow``, ``dynrow2``)."""
    if table.device.type == "cpu":
        return table[max(0, min(int(index), table.shape[0] - 1))][None]
    return _launch(table, MODE_SCALAR, index, None, 1)


def rowread_min(table, cursors):
    """(1, cols): the row at the minimum of the int32 `cursors` (any shape),
    reduced inside the block that reads the row (``dynrow3``)."""
    if table.device.type == "cpu":
        return table[cursors.min().clamp(0, table.shape[0] - 1).long()][None]
    return _launch(table, MODE_MIN, 0, cursors.reshape(-1), 1)


def rowread_rows(table, idx):
    """(n, cols): rows `idx` (int32 (n,)) of `table`, one block a row, each
    block loading its own index (``dynrow8`` with n = 8)."""
    if table.device.type == "cpu":
        return table[idx.clamp(0, table.shape[0] - 1).long()]
    return _launch(table, MODE_ROWS, 0, idx.reshape(-1), idx.numel())
