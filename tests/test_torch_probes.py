"""The plain versions of the brick-DDA and row-read kernels against the
JAX package's probes.

``scratch/r4_pallas2.py`` runs a benchmark when it is imported, so the math
it times (``dda_steps``, its lines 33-67) is copied here and run under
``jax.jit`` on the CPU. ``hit_idx9`` must be equal. ``hit_t`` and ``t_cur``
are held to rtol 1e-5 / atol 1e-6: XLA contracts ``bpos*tc - tb`` into a
fused multiply-add and the port rounds the product first (see
tests/test_torch_tile_trace.py); a float64 numpy run of the same steps with
float32 rounding after every operation pins the port's values bitwise."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracingtest_tpu_torch.ops import brick_dda, rowread
from tests.test_torch_threads import one_torch_thread  # noqa: F401

S_MAX = 23
DEPTH = 10
VSHIFT = S_MAX - DEPTH
VSIZE = np.float32(2.0 ** -DEPTH)
STEPS = 16


def _spread3(x):
    return (x & 1) | ((x & 2) << 2) | ((x & 4) << 4)


def jax_dda_steps(bpos, t_cur, walking, rw, tc, tb, flip, hit_t):
    """scratch/r4_pallas2.py::dda_steps, on per-component planes."""
    bpos = list(bpos)
    hit_idx9 = jnp.zeros_like(t_cur, dtype=jnp.int32)
    for _ in range(STEPS):
        li = [(jax.lax.bitcast_convert_type(bpos[a], jnp.int32) >> VSHIFT)
              & 7 for a in range(3)]
        aa = [li[a] ^ flip[a] for a in range(3)]
        idx9 = (_spread3(aa[0]) | (_spread3(aa[1]) << 1)
                | (_spread3(aa[2]) << 2))
        wsel = idx9 >> 5
        bitpos = (idx9 & 31).astype(jnp.uint32)
        acc = jnp.zeros_like(wsel, dtype=jnp.uint32)
        for j in range(16):
            acc = acc | jnp.where(wsel == j, rw[j], jnp.uint32(0))
        occ = ((acc >> bitpos) & 1) != 0
        hit_now = walking & occ & (t_cur < hit_t)
        t_corner = [bpos[a] * tc[a] - tb[a] for a in range(3)]
        tc_max = jnp.minimum(jnp.minimum(t_corner[0], t_corner[1]),
                             t_corner[2])
        adv = walking & ~hit_now
        step_bits = [t_corner[a] <= tc_max for a in range(3)]
        exit_b = adv & ((step_bits[0] & (li[0] == 0))
                        | (step_bits[1] & (li[1] == 0))
                        | (step_bits[2] & (li[2] == 0)))
        stay = adv & ~exit_b
        for a in range(3):
            bpos[a] = bpos[a] - jnp.where(step_bits[a] & stay, VSIZE,
                                          np.float32(0.0))
        t_cur = jnp.where(adv, jnp.maximum(t_cur, tc_max), t_cur)
        walking = stay
        hit_t = jnp.where(hit_now, t_cur, hit_t)
        hit_idx9 = jnp.where(hit_now, idx9, hit_idx9)
    return hit_t, hit_idx9, t_cur


def numpy_dda_steps(bpos, t_cur, walking, rw, tc, tb, flip, hit_t):
    """The same steps in numpy float32, every operation rounded on its own."""
    bpos = bpos.copy()
    t_cur, walking, hit_t = t_cur.copy(), walking.copy(), hit_t.copy()
    hit_idx9 = np.zeros(t_cur.shape, np.int32)
    lane = np.arange(t_cur.shape[0])
    for _ in range(STEPS):
        li = (bpos.view(np.int32) >> VSHIFT) & 7
        aa = li ^ flip
        idx9 = (_spread3(aa[:, 0]) | (_spread3(aa[:, 1]) << 1)
                | (_spread3(aa[:, 2]) << 2))
        w = rw[idx9 >> 5, lane]
        occ = ((w >> (idx9 & 31).astype(np.uint32)) & 1) != 0
        hit_now = walking & occ & (t_cur < hit_t)
        t_corner = (bpos * tc).astype(np.float32) - tb
        tc_max = t_corner.min(axis=1)
        adv = walking & ~hit_now
        step_bits = t_corner <= tc_max[:, None]
        exit_b = adv & (step_bits & (li == 0)).any(axis=1)
        stay = adv & ~exit_b
        bpos = bpos - np.where(step_bits & stay[:, None], VSIZE, np.float32(0))
        t_cur = np.where(adv, np.maximum(t_cur, tc_max), t_cur)
        walking = stay
        hit_t = np.where(hit_now, t_cur, hit_t)
        hit_idx9 = np.where(hit_now, idx9, hit_idx9)
    return hit_t, hit_idx9, t_cur


def make_inputs(n, seed):
    """numpy inputs with the distributions of the probe's make_inputs."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    bpos = (1.0 + rng.random((n, 3), dtype=f32) * f32(0.9)).astype(f32)
    t_cur = rng.random(n, dtype=f32)
    walking = rng.random(n) < 0.7
    rw = rng.integers(0, 2 ** 31 - 1, (16, n), dtype=np.int64).astype(np.uint32)
    tc = (-1.0 - rng.random((n, 3), dtype=f32)).astype(f32)
    tb = rng.random((n, 3), dtype=f32)
    flip = (rng.integers(0, 2, (n, 3)) * 7).astype(np.int32)
    hit_t = np.full(n, np.inf, f32)
    return bpos, t_cur, walking, rw, tc, tb, flip, hit_t


def to_torch(args):
    bpos, t_cur, walking, rw, tc, tb, flip, hit_t = args
    t = torch.from_numpy
    return (t(bpos), t(t_cur), t(walking), t(rw.view(np.int32)), t(tc), t(tb),
            t(flip), t(hit_t))


@pytest.mark.parametrize("n,seed,top_bit", [(4096, 0, False), (1000, 1, True)])
def test_dda_steps_matches_probe(n, seed, top_bit):
    args = make_inputs(n, seed)
    if top_bit:  # words with bit 31 set: negative as int32 bit patterns
        args[3][:] |= np.uint32(0x80000000)
    bpos, t_cur, walking, rw, tc, tb, flip, hit_t = args
    planes = lambda x: tuple(jnp.asarray(x[:, a]) for a in range(3))
    ref = jax.jit(jax_dda_steps)(
        planes(bpos), jnp.asarray(t_cur), jnp.asarray(walking),
        [jnp.asarray(rw[j]) for j in range(16)], planes(tc), planes(tb),
        planes(flip), jnp.asarray(hit_t))
    ours = brick_dda.brick_dda16(*to_torch(args), depth=DEPTH, steps=STEPS)
    assert [o.dtype for o in ours] == [torch.float32, torch.int32, torch.float32]
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))
    for a, b in ((ours[0], ref[0]), (ours[2], ref[2])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    assert np.isfinite(ours[0].numpy()).sum() > n // 4  # rays do hit
    exact = numpy_dda_steps(*args)
    for a, b in zip(ours, exact):
        np.testing.assert_array_equal(a.numpy().view(np.int32), b.view(np.int32))


def test_dda_wrapper_contract():
    args = to_torch(make_inputs(256, 2))
    before = brick_dda.launches
    a = brick_dda.brick_dda16(*args)
    b = brick_dda.dda_steps(*args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert brick_dda.launches == before  # CPU tensors never launch
    with pytest.raises(ValueError):
        brick_dda._dda_kernel(*args, 10, 16)
    # zero steps leave the state as it came
    hit_t, idx9, t_cur = brick_dda.brick_dda16(*args, steps=0)
    assert torch.equal(t_cur, args[1]) and bool((idx9 == 0).all())
    assert bool(torch.isinf(hit_t).all())


@pytest.fixture
def table():
    return torch.arange(64 * 128, dtype=torch.int32).reshape(64, 128)


@pytest.mark.parametrize("index", [17, 0, 63])
def test_rowread_scalar(table, index):
    out = rowread.rowread_scalar(table, index)
    assert out.shape == (1, 128) and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), table.numpy()[index:index + 1])


def test_rowread_min(table):
    cur = torch.full((8, 128), 9, dtype=torch.int32)
    np.testing.assert_array_equal(rowread.rowread_min(table, cur).numpy(),
                                  table.numpy()[9:10])
    rng = np.random.default_rng(3)
    cur = torch.from_numpy(rng.integers(5, 64, (8, 128)).astype(np.int32))
    np.testing.assert_array_equal(rowread.rowread_min(table, cur).numpy(),
                                  table.numpy()[int(cur.min())][None])


def test_rowread_rows(table):
    idx = torch.arange(8, dtype=torch.int32) * 3
    out = rowread.rowread_rows(table, idx)
    assert out.shape == (8, 128)
    np.testing.assert_array_equal(out.numpy(), table.numpy()[idx.numpy()])


def test_rowread_clips_and_refuses_cpu_launch(table):
    np.testing.assert_array_equal(rowread.rowread_scalar(table, 99).numpy(),
                                  table.numpy()[63:64])
    idx = torch.tensor([-4, 70], dtype=torch.int32)
    np.testing.assert_array_equal(rowread.rowread_rows(table, idx).numpy(),
                                  table.numpy()[[0, 63]])
    before = rowread.launches
    with pytest.raises(ValueError):
        rowread._launch(table, rowread.MODE_SCALAR, 1, None, 1)
    assert rowread.launches == before
