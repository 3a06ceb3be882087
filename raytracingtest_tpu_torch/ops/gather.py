"""Gathers at run-time indices, and a loop that lives inside one kernel.

Counterparts of the gather and loop probes in ``scratch/probe_kernel.py``
and ``scratch/probe2.py``, which asked what a TPU kernel can gather and what
a trip of a loop inside a kernel costs:

  * ``take_1d``          ``p2a_take_1d``: ``out[s,l] = table[idx[s,l]]``;
  * ``take_onehot``      ``p2d_onehot``: the same gather of a ``(rows, 1)``
                         float32 table as a one-hot matrix product
                         (compare with every row, multiply, accumulate);
  * ``take_along0``      ``p2b_take_2d_axis0`` and ``probe2.gather_axis0``:
                         ``out[s,l] = table[idx[s,l], l]``;
  * ``take_along_lane``  ``p2c_take_along_lane``: ``out[s,l] = x[s, idx[s,l]]``;
  * ``loop_probe``       ``p1_kernel_loop`` and ``probe2.pallas_loop_slope``
                         (float mode, without and with a gather each trip)
                         and ``p2e_take_2d_big`` (integer mode);
  * ``loop_probe_serial`` the same loop through the kernel's first form.

Two kernels of ``csrc/shade.cu`` serve them, ``take`` (three index modes
on any 32-bit element, and the one-hot product on float32) and
``loop_probe`` (its ranged form: floor only where a step's input may lie
outside [0, 1], the integer loop's loads issued eight trips ahead; its
first form ``loop_probe_serial``, floor in every step); both read through
the row load that the shading kernels fetch their parameter rows with. CUDA
tensors launch the kernel, CPU tensors take the plain version beside it.
Indices are clipped to the table, in both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from raytracingtest_tpu_torch._build import shade_lib
from raytracingtest_tpu_torch._launch import Kernel

_F32, _I32 = torch.float32, torch.int32

TAKE_1D, TAKE_ALONG0, TAKE_ALONG_LANE, TAKE_ONEHOT = 0, 1, 2, 3
LOOP_FLOAT, LOOP_INT = 0, 1

# kernel launches made by this process, by kernel
launches = {"take": 0, "loop_probe": 0, "loop_probe_serial": 0}

_TAKE = Kernel("take", shade_lib)
_LOOP_PROBE = Kernel("loop_probe", shade_lib)
_LOOP_PROBE_SERIAL = Kernel("loop_probe_serial", shade_lib)


def _take_guards(table, idx, mode):
    """(dtype, shape, indices' shape, rows, cols) of a gather the kernel
    takes; raises ValueError on any other. One pass: each attribute is read
    once, and the table's own dtype and shape go on to the check."""
    dtype, shape, idx_shape = table.dtype, table.shape, idx.shape
    if dtype not in (_F32, _I32) or table.numel() == 0:
        raise ValueError(f"table: expected a non-empty float32 or int32 "
                         f"tensor, got {dtype} {tuple(shape)}")
    if mode in (TAKE_1D, TAKE_ONEHOT):
        if len(shape) != 1:
            raise ValueError(f"table has shape {tuple(shape)}, expected (rows,)")
        rows, cols = shape[0], 1
    else:
        if len(shape) != 2 or len(idx_shape) != 2 or idx_shape[1] != shape[1]:
            raise ValueError(f"table {tuple(shape)} and indices "
                             f"{tuple(idx_shape)}: expected (rows, cols) and (n, cols)")
        if mode == TAKE_ALONG_LANE and idx_shape != shape:
            raise ValueError("a lane gather takes indices of the table's shape")
        rows, cols = shape
    return dtype, shape, idx_shape, rows, cols


def _take_kernel(table, idx, mode):
    dtype, shape, idx_shape, rows, cols = _take_guards(table, idx, mode)
    device = table.device
    _TAKE.check(device, (("table", table, dtype, shape),
                         ("indices", idx, _I32, idx_shape)))
    # the indices' shape, contiguous, on their device: empty_like is the
    # cheapest call that makes it
    out = torch.empty_like(idx, dtype=dtype)
    _TAKE(device, table.data_ptr(), idx.data_ptr(), out.data_ptr(),
          out.numel(), rows, cols, mode)
    launches["take"] += 1
    return out


def _clipped(idx, rows):
    return idx.clamp(0, rows - 1).long()


def take_1d(table, idx):
    """``table[idx]`` for a 1-D float32 or int32 `table` and int32 `idx` of
    any shape."""
    if table.device.type == "cpu":
        return table[_clipped(idx, table.shape[0])]
    return _take_kernel(table, idx, TAKE_1D)


def onehot_take_plain(table, idx):
    """``one_hot(idx, rows) @ table`` for a ``(rows, 1)`` float32 table: a
    row of the one-hot matrix holds a single 1, so the product is exact and
    equals the gather bit for bit (of finite values; a -0.0 comes out +0.0)."""
    rows = table.shape[0]
    onehot = F.one_hot(_clipped(idx, rows).reshape(-1), rows).to(_F32)
    return (onehot @ table).reshape(idx.shape)


def take_onehot(table, idx):
    """The gather ``table[idx, 0]`` of a ``(rows, 1)`` float32 table, shaped
    as `idx`, computed as the one-hot product by kernel and plain version
    alike: every output reads every row."""
    if table.dim() != 2 or table.shape[1] != 1 or table.dtype != _F32:
        raise ValueError(f"table: expected float32 (rows, 1), got "
                         f"{table.dtype} {tuple(table.shape)}")
    if table.device.type == "cpu":
        return onehot_take_plain(table, idx)
    return _take_kernel(table.reshape(-1), idx, TAKE_ONEHOT)


def take_along0(table, idx):
    """``out[s,l] = table[idx[s,l], l]`` for a ``(rows, cols)`` table and
    ``(n, cols)`` int32 indices."""
    if table.device.type == "cpu":
        return torch.gather(table, 0, _clipped(idx, table.shape[0]))
    return _take_kernel(table, idx, TAKE_ALONG0)


def take_along_lane(x, idx):
    """``out[s,l] = x[s, idx[s,l]]`` for `x` and int32 `idx` of one 2-D
    shape."""
    if x.device.type == "cpu":
        return torch.gather(x, 1, _clipped(idx, x.shape[1]))
    return _take_kernel(x, idx, TAKE_ALONG_LANE)


def loop_probe_plain(x, table, iters, elem, gather_rows, mode):
    """The loop as a Python loop of the same tensor operations, each rounded
    on its own."""
    if mode == LOOP_INT:
        acc = torch.zeros_like(x)
        for k in range(iters):
            acc = acc + torch.gather(
                table, 0, _clipped((x + k) % gather_rows, table.shape[0]))
        return acc
    scale = torch.tensor(1.000001, dtype=_F32, device=x.device)
    half = torch.tensor(0.5, dtype=_F32, device=x.device)
    tiny = torch.tensor(1e-9, dtype=_F32, device=x.device)
    for _ in range(iters):
        for _ in range(elem):
            x = x * scale + half
            x = x - torch.floor(x)
        if gather_rows:
            idx = x.view(_I32) & (gather_rows - 1)
            x = x + torch.gather(table, 0, _clipped(idx, table.shape[0])) * tiny
    return x


def _loop_kernel(x, table, iters, elem, gather_rows, mode, kernel=_LOOP_PROBE):
    device = x.device
    specs = [("x", x, _I32 if mode == LOOP_INT else _F32, x.shape)]
    if table is not None:
        specs.append(("table", table, x.dtype, (table.shape[0], x.shape[1])))
    kernel.check(device, specs)
    out = torch.empty_like(x)
    kernel(device, x.data_ptr(), 0 if table is None else table.data_ptr(),
           out.data_ptr(), x.numel(), x.shape[1],
           0 if table is None else table.shape[0], iters, elem, gather_rows, mode)
    launches[kernel.name] += 1
    return out


def loop_probe(x, table=None, iters=256, elem=8, gather_rows=0,
               mode=LOOP_FLOAT):
    """`iters` trips of a loop over every element of the 2-D `x`.

    ``LOOP_FLOAT`` (`x` float32): a trip is `elem` times ``x = x*1.000001 +
    0.5; x -= floor(x)``; with `gather_rows` (a power of two) it then adds
    ``table[bits(x) & (gather_rows-1), lane] * 1e-9`` from the float32
    ``(rows, cols)`` `table`. ``LOOP_INT`` (`x` int32): the result is the sum
    over the trips k of ``table[(x + k) mod gather_rows, lane]`` from the
    int32 `table`. Row indices are clipped to the table."""
    return _loop(_LOOP_PROBE, x, table, iters, elem, gather_rows, mode)


def loop_probe_serial(x, table=None, iters=256, elem=8, gather_rows=0,
                      mode=LOOP_FLOAT):
    """``loop_probe`` through the kernel's first form (floor in every step,
    one load a trip), kept as the check and yardstick of its ranged form."""
    return _loop(_LOOP_PROBE_SERIAL, x, table, iters, elem, gather_rows, mode)


def _loop(kernel, x, table, iters, elem, gather_rows, mode):
    if mode not in (LOOP_FLOAT, LOOP_INT) or x.dim() != 2:
        raise ValueError(f"mode {mode} or x of shape {tuple(x.shape)}: expected "
                         f"LOOP_FLOAT or LOOP_INT and a 2-D x")
    if iters < 0 or elem < 0 or gather_rows < 0:
        raise ValueError("iters, elem and gather_rows must not be negative")
    gathers = gather_rows > 0
    if mode == LOOP_INT and not gathers:
        raise ValueError("the integer loop needs gather_rows, its modulus")
    if mode == LOOP_FLOAT and gathers and gather_rows & (gather_rows - 1):
        raise ValueError(f"gather_rows {gather_rows} is not a power of two")
    if gathers and (table is None or table.dim() != 2 or table.shape[0] < 1
                    or table.shape[1] != x.shape[1]):
        raise ValueError("a loop that gathers needs a (rows, cols) table of x's width")
    if not gathers:
        table = None
    if x.device.type == "cpu":
        return loop_probe_plain(x, table, iters, elem, gather_rows, mode)
    return _loop_kernel(x, table, iters, elem, gather_rows, mode, kernel)
