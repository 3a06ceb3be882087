"""The port's Perlin and OpenSimplex noise against the JAX package's numpy
path: values bitwise, seeds' permutations and the Lipschitz constants
equal. Inputs come from numpy seeds; both packages see identical arrays."""

import numpy as np
import pytest

from raytracingtest_tpu.utils import opensimplex as jax_os
from raytracingtest_tpu.utils import perlin as jax_perlin

from raytracingtest_tpu_torch.utils import opensimplex, perlin
from tests.test_torch_threads import one_torch_thread  # noqa: F401


def _coords(seed, n=4000, lo=-20.0, hi=20.0):
    rng = np.random.default_rng(seed)
    c = rng.random((3, n), dtype=np.float32) * np.float32(hi - lo) + np.float32(lo)
    # lattice points, half-cells and the 255/256 wrap of the table
    c[:, :6] = np.float32([[0, 1, -1, 0.5, 255, 256]] * 3)
    return c


@pytest.mark.parametrize("fn,arity", [("noise1", 1), ("noise2", 2), ("noise3", 3)])
def test_perlin_noise_bitwise(fn, arity):
    c = _coords(1)
    ours = getattr(perlin, fn)(*c[:arity])
    ref = getattr(jax_perlin, fn)(*c[:arity], xp=np)
    assert ours.dtype == np.float32 and ours.shape == (c.shape[1],)
    assert ours.tobytes() == np.asarray(ref, np.float32).tobytes()


@pytest.mark.parametrize("octaves", [1, 2, 5])
def test_perlin_fbm_bitwise(octaves):
    c = _coords(2)
    ours = perlin.fbm3(*c, octaves)
    ref = jax_perlin.fbm3(*c, octaves, xp=np)
    assert ours.tobytes() == np.asarray(ref, np.float32).tobytes()
    ours1 = perlin.fbm1(c[0], octaves)
    assert ours1.tobytes() == np.asarray(jax_perlin.fbm1(c[0], octaves, xp=np),
                                         np.float32).tobytes()


def test_perlin_tables_and_bounds():
    assert perlin.PERM.dtype == jax_perlin.PERM.dtype
    np.testing.assert_array_equal(perlin.PERM, jax_perlin.PERM)
    assert perlin.PERLIN3_LIPSCHITZ == jax_perlin.PERLIN3_LIPSCHITZ
    for octaves in (1, 2, 3):
        assert (perlin.perlin_fbm3_lipschitz(octaves)
                == jax_perlin.perlin_fbm3_lipschitz(octaves))


@pytest.mark.parametrize("seed", [7, 0, -3, 2**40 + 11])
def test_opensimplex_perm_matches(seed):
    for ours, ref in zip(opensimplex.make_perm(seed), jax_os.make_perm(seed)):
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("seed,scale", [(7, 3.0), (7, 24.0), (123, 6.0)])
def test_opensimplex_evaluate_bitwise(seed, scale):
    # float64 in and out, as the reference's numpy path evaluates
    c = (_coords(seed % 100 + 3).astype(np.float64) + 20.0) / 40.0 * scale
    ours = opensimplex.OpenSimplex3D(seed).evaluate(*c)
    ref = jax_os.OpenSimplex3D(seed).evaluate(*c, xp=np)
    assert ours.dtype == np.float64 == ref.dtype
    assert ours.tobytes() == ref.tobytes()
    # broadcasting over a grid
    g = np.linspace(0.0, 4.0, 9)
    ours = opensimplex.OpenSimplex3D(seed).evaluate(g[:, None, None], g[None, :, None], 0.25)
    ref = jax_os.OpenSimplex3D(seed).evaluate(g[:, None, None], g[None, :, None], 0.25, xp=np)
    assert ours.shape == ref.shape == (9, 9, 1)
    assert ours.tobytes() == ref.tobytes()


def test_opensimplex_tables_and_bound():
    assert opensimplex.OPENSIMPLEX3_LIPSCHITZ == jax_os.OPENSIMPLEX3_LIPSCHITZ
    assert opensimplex.MAX_CHAIN == jax_os.MAX_CHAIN
    for ours, ref in zip((opensimplex._LUT_D, opensimplex._LUT_SB, opensimplex._LUT_N),
                         (jax_os._LUT_D, jax_os._LUT_SB, jax_os._LUT_N)):
        assert ours.dtype == ref.dtype and ours.tobytes() == ref.tobytes()


def test_opensimplex_blocked_evaluation_bitwise():
    """Above EVAL_BLOCK points the port evaluates block by block on several
    threads: the same bits as the reference's one pass, broadcast shapes
    included."""
    n = 2 * opensimplex.EVAL_BLOCK + 123
    c = (_coords(9, n=n).astype(np.float64) + 20.0) / 40.0 * 24.0
    ours = opensimplex.OpenSimplex3D(7).evaluate(*c)
    ref = jax_os.OpenSimplex3D(7).evaluate(*c, xp=np)
    assert ours.shape == (n,) and ours.tobytes() == ref.tobytes()
    x = c[0, :n - 123].reshape(-1, 512)
    ours = opensimplex.OpenSimplex3D(7).evaluate(x, 0.75, x.T[:1].T)
    ref = jax_os.OpenSimplex3D(7).evaluate(x, 0.75, x.T[:1].T, xp=np)
    assert ours.shape == ref.shape == x.shape and ours.tobytes() == ref.tobytes()
