"""The plain versions of the ``take`` and ``loop_probe`` kernels against the
JAX package's gather and loop probes.

``scratch/probe_kernel.py`` and ``scratch/probe2.py`` return times, not
arrays, and wrap each body in a ``pallas_call`` with TPU memory specs, so
each body's ``jnp`` expression is copied here and run under ``jax.jit`` on
the CPU. Tolerances: the integer gathers and the integer loop are equal; the
one-hot product equals the gather bit for bit (a row of the one-hot matrix
holds a single 1). The float loop is held against XLA to one unit in the
last place of 1.0 for each of its 64 x 8 steps, 512 * 2**-23 = 6.1e-5: XLA
contracts ``x*1.000001 + 0.5`` into one rounding, which moves a step by up
to half a unit, always the same way (measured: 3.05e-5 = 512 * 2**-24). The
distance is taken around the unit circle, because the loop keeps fractions
and a last-bit difference at a whole number wraps. Against a numpy float32
loop that rounds every operation on its own, as the kernel does, the loop is
held bitwise, and so is a numpy model of the kernel's ranged form, which
takes floor only where a step's input may lie outside [0, 1].
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracingtest_tpu_torch.ops import gather
from tests.test_torch_threads import one_torch_thread  # noqa: F401


def probe_idx(shape, rows):
    """The probes' index pattern."""
    return ((np.arange(shape[0] * shape[1], dtype=np.int32).reshape(shape) * 7919)
            % rows).astype(np.int32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_take_1d_matches_probe():
    """p2a_take_1d: jnp.take(table_1d, idx2d)."""
    table = np.arange(16384, dtype=np.int32) * 3 + 1
    idx = probe_idx((8, 128), 16384)
    ref = jax.jit(lambda a, i: jnp.take(a, i, axis=0))(table, idx)
    ours = gather.take_1d(t(table), t(idx))
    assert ours.dtype == torch.int32 and ours.shape == (8, 128)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    as_float = gather.take_1d(t(table.astype(np.float32)), t(idx))
    np.testing.assert_array_equal(as_float.numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("rows,n_idx", [(16384, 8), (8, 8), (16, 16), (32, 32),
                                         (64, 64), (256, 256), (1024, 1024)])
def test_take_along0_matches_probes(rows, n_idx):
    """p2b_take_2d_axis0 (16,384 rows, 8 index rows) and probe2.gather_axis0
    (same-shape, 8 to 1024 rows): take_along_axis(table, idx, axis=0)."""
    table = np.arange(rows * 128, dtype=np.int32).reshape(rows, 128)
    idx = probe_idx((n_idx, 128), rows)
    ref = jax.jit(lambda a, i: jnp.take_along_axis(a, i, axis=0))(table, idx)
    ours = gather.take_along0(t(table), t(idx))
    assert ours.shape == (n_idx, 128)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_take_along_lane_matches_probe():
    """p2c_take_along_lane: take_along_axis(x, idx, axis=1)."""
    x = np.arange(8 * 128, dtype=np.int32).reshape(8, 128)
    idx = (x * 13) % 128
    ref = jax.jit(lambda a, i: jnp.take_along_axis(a, i, axis=1))(x, idx)
    np.testing.assert_array_equal(gather.take_along_lane(t(x), t(idx)).numpy(),
                                  np.asarray(ref))


def test_onehot_product_is_the_gather_bitwise():
    """p2d_onehot: one_hot(idx, rows) @ table. The plain version is that
    product, as the kernel's one-hot mode is on the card; a one-hot row holds
    a single 1, so the product must be the bits of the gather."""
    rows = 4096
    rng = np.random.default_rng(0)
    table = rng.normal(size=(rows, 1)).astype(np.float32)
    idx = probe_idx((8, 128), rows)

    def body(tab, i):
        cols = jax.lax.broadcasted_iota(jnp.int32, (8 * 128, rows), 1)
        oh = (cols == i.reshape(-1, 1)).astype(jnp.float32)
        return jnp.dot(oh, tab, preferred_element_type=jnp.float32).reshape(8, 128)

    ref = np.asarray(jax.jit(body)(table, idx))
    ours = gather.take_onehot(t(table), t(idx))
    assert ours.dtype == torch.float32 and ours.shape == (8, 128)
    gathered = gather.take_1d(t(table[:, 0]), t(idx))
    np.testing.assert_array_equal(ours.numpy().view(np.int32),
                                  gathered.numpy().view(np.int32))
    np.testing.assert_array_equal(ours.numpy().view(np.int32), ref.view(np.int32))


def numpy_int_loop(x, table, iters, rows):
    """The integer loop as the kernel's ranged form runs it: eight trips'
    rows fetched, then added in order, int32 wrapping (x + k and the sum)."""
    acc = np.zeros_like(x)
    lanes = np.arange(x.shape[1])[None, :]
    for k0 in range(0, iters, 8):
        fetched = [table[np.clip((x + np.int32(k)) % rows, 0, table.shape[0] - 1), lanes]
                   for k in range(k0, min(k0 + 8, iters))]
        for row in fetched:
            acc = acc + row
    return acc


def test_integer_loop_matches_probe():
    """p2e_take_2d_big: 256 trips of acc += table[(idx + k) % rows, lane];
    then on indices whose x + k wraps past 2**31 - 1 or lies below zero, and
    a table of large and negative words whose sums wrap."""
    rows, iters = 16384, 256
    table = np.arange(rows * 128, dtype=np.int32).reshape(rows, 128)
    idx = probe_idx((8, 128), rows)

    @jax.jit
    def body(tab, i):
        def trip(k, acc):
            return acc + jnp.take_along_axis(tab, (i + k) % rows, axis=0)
        return jax.lax.fori_loop(0, iters, trip, jnp.zeros((8, 128), jnp.int32))

    ref = body(table, idx)
    ours = gather.loop_probe(t(idx), t(table), iters=iters, elem=0,
                             gather_rows=rows, mode=gather.LOOP_INT)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(numpy_int_loop(idx, table, iters, rows), np.asarray(ref))

    near_max = np.int32(2**31 - 1) - probe_idx((4, 128), 300)
    below_zero = -probe_idx((4, 128), 2**31 - 1) - np.int32(1)
    wrapping = np.concatenate([near_max, below_zero])
    words = np.random.default_rng(3).integers(-2**31, 2**31, (rows, 128)).astype(np.int32)
    assert (near_max.astype(np.int64) + iters - 1 > 2**31 - 1).any()
    ref = np.asarray(body(words, wrapping))
    ours = gather.loop_probe(t(wrapping), t(words), iters=iters, elem=0,
                             gather_rows=rows, mode=gather.LOOP_INT)
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_array_equal(numpy_int_loop(wrapping, words, iters, rows), ref)


def numpy_float_loop(x, table, iters, elem, gather_rows):
    """The float loop in numpy float32, every operation rounded on its own."""
    f32 = np.float32
    x = x.copy()
    lanes = np.arange(x.shape[1])[None, :]
    for _ in range(iters):
        for _ in range(elem):
            x = x * f32(1.000001) + f32(0.5)
            x = x - np.floor(x)
        if gather_rows:
            idx = np.clip(x.view(np.int32) & (gather_rows - 1), 0, table.shape[0] - 1)
            x = x + table[idx, lanes] * f32(1e-9)
    return x


SHADE_CU = os.path.join(os.path.dirname(gather.__file__), os.pardir, "csrc", "shade.cu")
STEP_SCALE, STEP_ADD = np.float32(1.000001), np.float32(0.5)


def kernel_wrap_at():
    """The ranged form's LOOP_WRAP_AT, as csrc/shade.cu writes it."""
    with open(SHADE_CU) as f:
        m = re.search(r"LOOP_WRAP_AT = (0x[0-9a-f.]+p[-+]?\d+)f;", f.read())
    return np.float32(float.fromhex(m.group(1)))


def all_floats(lo, hi):
    """Every float32 in [lo, hi), both non-negative."""
    bits = np.arange(np.float32(lo).view(np.int32), np.float32(hi).view(np.int32),
                     dtype=np.int32)
    return bits.view(np.float32)


def step_any(v):
    w = v * STEP_SCALE + STEP_ADD
    return w - np.floor(w)


def step_unit(v, wrap_at):
    return (v * STEP_SCALE + STEP_ADD) - (v >= wrap_at).astype(np.float32)


@pytest.mark.parametrize("claim", ["w", "v"])
def test_fast_step_keeps_the_bits(claim):
    """w: for every float32 w in [0.5, 1.6), w - 1 where w >= 1, else w, is
    w - floor(w) bitwise (w - 1 is exact there). v: for every float32 v in
    [0.25, 1], the kernel's step without floor (the 0 or 1 taken from v >=
    LOOP_WRAP_AT) is the step with it; LOOP_WRAP_AT is the least v whose w
    reaches 1, and below 0.25 neither side reaches it (w is monotone in v)."""
    if claim == "w":
        w = all_floats(0.5, 1.6)
        fast = np.where(w >= 1, w - np.float32(1), w)
        np.testing.assert_array_equal(fast.view(np.int32), (w - np.floor(w)).view(np.int32))
        return
    wrap_at = kernel_wrap_at()
    v = np.concatenate([all_floats(0.25, 1.0), [np.float32(1.0)]])
    np.testing.assert_array_equal(step_unit(v, wrap_at).view(np.int32),
                                  step_any(v).view(np.int32))
    below = np.nextafter(wrap_at, np.float32(0))
    assert wrap_at * STEP_SCALE + STEP_ADD >= 1 > below * STEP_SCALE + STEP_ADD
    assert np.float32(0.25) * STEP_SCALE + STEP_ADD < 1 and wrap_at > 0.25


def numpy_ranged_loop(x, table, iters, elem, gather_rows):
    """The float loop as the kernel's ranged form runs it: step_any where the
    input may lie outside [0, 1] (the first step, and the first after each
    gather), step_unit everywhere else."""
    wrap_at, f32 = kernel_wrap_at(), np.float32
    x = x.copy()
    lanes = np.arange(x.shape[1])[None, :]
    if gather_rows:
        for _ in range(iters):
            if elem:
                x = step_any(x)
                for _ in range(elem - 1):
                    x = step_unit(x, wrap_at)
            idx = np.clip(x.view(np.int32) & (gather_rows - 1), 0, table.shape[0] - 1)
            x = x + table[idx, lanes] * f32(1e-9)
    elif iters and elem:
        x = step_any(x)
        for _ in range(iters * elem - 1):
            x = step_unit(x, wrap_at)
    return x


def outside_unit(shape, seed):
    """Floats that leave [0, 1]: negative, at and past 2**23, -0.0, NaN,
    +-inf, the largest and overflowing, tiny, just below 1 and around the
    wrap, the rest spread over twelve decades of both signs."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 9, shape)).astype(np.float32)
    special = np.array([-3.7, -0.0, 0.0, 2**23, 2**23 + 1, 2**24 + 3, 3.4e38, -3.4e38,
                        1e-40, -1e-10, np.nan, np.inf, -np.inf, 1.0, 0.5,
                        np.nextafter(np.float32(1), np.float32(0)), 0.4999995, 0.49999946,
                        -0.5, 12345.678], dtype=np.float32)
    x.reshape(-1)[:special.size] = special
    return x


@pytest.mark.parametrize("gather_rows,inputs", [
    pytest.param(0, "probe", id="0"),
    pytest.param(512, "probe", id="512"),
    pytest.param(0, "outside", id="0-outside"),
    pytest.param(512, "outside", id="512-outside"),
    pytest.param(512, "outside table", id="512-outside-table"),
])
def test_float_loop_matches_probe(gather_rows, inputs):
    """p1_kernel_loop and probe2.pallas_loop_slope at 64 trips of 8 steps on
    (512,128), without and with a 512-row gather each trip; then on inputs
    outside [0, 1] ("outside"), and with a table of large, negative, infinite
    and NaN words as well ("outside table"). Against XLA only where the table
    lies in [0, 1): there a row read one unit apart moves the sum by at most
    1e-9, but a large row would move it by anything."""
    rows, elem, iters = 512, 8, 64
    x = np.linspace(0, 1, rows * 128).reshape(rows, 128).astype(np.float32)
    table = np.random.default_rng(1).random((rows, 128), dtype=np.float32)
    if inputs != "probe":
        x = outside_unit(x.shape, 2)
    if inputs == "outside table":
        with np.errstate(over="ignore"):
            table = outside_unit(table.shape, 4) * np.float32(1e6)

    def body(x0, tab):
        def trip(k, v):
            for _ in range(elem):
                v = v * 1.000001 + 0.5
                v = v - jnp.floor(v)
            if gather_rows:
                idx = jax.lax.bitcast_convert_type(v, jnp.int32) & (gather_rows - 1)
                v = v + jnp.take_along_axis(tab, idx, axis=0) * 1e-9
            return v
        return jax.lax.fori_loop(0, iters, trip, x0)

    ours = gather.loop_probe(t(x), t(table), iters=iters, elem=elem,
                             gather_rows=gather_rows).numpy()
    with np.errstate(over="ignore", invalid="ignore"):
        exact = numpy_float_loop(x, table, iters, elem, gather_rows)
        model = numpy_ranged_loop(x, table, iters, elem, gather_rows)
    np.testing.assert_array_equal(ours.view(np.int32), exact.view(np.int32))
    np.testing.assert_array_equal(model.view(np.int32), exact.view(np.int32))
    assert ours.dtype == np.float32
    if inputs == "outside table":
        assert np.isnan(ours).any() and (np.abs(ours) > 1.001).any()
        return
    ref = np.asarray(jax.jit(body)(x, table))
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    kept = ~np.isnan(ours)
    assert ((ours[kept] >= 0) & (ours[kept] < 1.001)).all()
    assert (np.isnan(ours).sum() == 0) == (inputs == "probe")
    apart = np.abs(ours[kept] - ref[kept])
    assert np.minimum(apart, 1.0 - apart).max() <= iters * elem * 2.0 ** -23


def test_loop_without_trips_returns_its_input():
    x = torch.rand((4, 128))
    assert torch.equal(gather.loop_probe(x, iters=0), x)


def test_indices_are_clipped_to_the_table():
    table = torch.arange(10, dtype=torch.int32)
    idx = torch.tensor([[-3, 0, 9, 40]], dtype=torch.int32)
    np.testing.assert_array_equal(gather.take_1d(table, idx).numpy(), [[0, 0, 9, 9]])
    table2 = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    np.testing.assert_array_equal(gather.take_along0(table2, idx).numpy(),
                                  [[0, 1, 10, 11]])
    np.testing.assert_array_equal(gather.take_along_lane(table2[:1], idx).numpy(),
                                  [[0, 0, 3, 3]])


def test_wrappers_never_launch_on_the_cpu_and_refuse_bad_arguments():
    table = torch.arange(16, dtype=torch.int32)
    idx = torch.zeros((2, 8), dtype=torch.int32)
    before = dict(gather.launches)
    gather.take_1d(table, idx)
    x = torch.rand((2, 8))
    assert torch.equal(gather.loop_probe(x, iters=2), gather.loop_probe_serial(x, iters=2))
    assert gather.launches == before
    with pytest.raises(ValueError):
        gather._take_kernel(table, idx, gather.TAKE_1D)       # a CPU tensor
    with pytest.raises(ValueError):
        gather._loop_kernel(torch.rand((2, 8)), None, 1, 1, 0, gather.LOOP_FLOAT)
    with pytest.raises(ValueError):
        gather._loop_kernel(torch.rand((2, 8)), None, 1, 1, 0, gather.LOOP_FLOAT,
                            gather._LOOP_PROBE_SERIAL)
    with pytest.raises(ValueError):
        gather.loop_probe_serial(idx, mode=gather.LOOP_INT)   # no modulus
    with pytest.raises(ValueError):
        gather.take_onehot(torch.zeros((4, 2)), idx)          # not (rows, 1)
    with pytest.raises(ValueError):
        gather.loop_probe(torch.rand((2, 8)), torch.rand((6, 8)), gather_rows=6)
    with pytest.raises(ValueError):
        gather.loop_probe(idx, mode=gather.LOOP_INT)          # no modulus
    with pytest.raises(ValueError):
        gather.loop_probe(torch.rand((2, 8)), torch.rand((4, 4)), gather_rows=4)
    with pytest.raises(ValueError):
        gather.loop_probe(torch.rand(8))                      # not 2-D
    assert gather.launches == before
