"""The port's Morton codes (ops/morton.py) against the JAX package's: every
function, 32- and 64-bit, on seeded numpy input, and the 32-bit pair on
int32 tensors (codes as int32 bit patterns)."""

import numpy as np
import pytest
import torch

from raytracingtest_tpu.ops import morton as jax_morton

from raytracingtest_tpu_torch.ops import morton
from tests.test_torch_threads import one_torch_thread  # noqa: F401


def _coords(seed, n, bits, dtype):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 1 << bits, n).astype(dtype) for _ in range(3))


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.int64])
def test_encode_matches_jax(dtype):
    x, y, z = _coords(0, 2000, 10, dtype)
    ours = morton.morton_encode(x, y, z)
    ref = jax_morton.morton_encode(x, y, z, xp=np)
    assert ours.dtype == ref.dtype == np.uint32
    np.testing.assert_array_equal(ours, ref)


def test_decode_matches_jax_and_round_trips():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 1 << 32, 2000, dtype=np.uint64).astype(np.uint32)
    ours = morton.morton_decode(codes)
    ref = jax_morton.morton_decode(codes, xp=np)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    x, y, z = _coords(2, 1000, 10, np.uint32)
    back = morton.morton_decode(morton.morton_encode(x, y, z))
    for a, b in zip(back, (x, y, z)):
        np.testing.assert_array_equal(a, b.astype(np.int32))


def test_tensor_path_matches_numpy_bitwise():
    x, y, z = _coords(3, 3000, 10, np.int32)
    code = morton.morton_encode(*(torch.from_numpy(c) for c in (x, y, z)))
    assert code.dtype == torch.int32
    ref = jax_morton.morton_encode(x, y, z, xp=np)
    np.testing.assert_array_equal(code.numpy().view(np.uint32), ref)
    back = morton.morton_decode(code)
    for a, b in zip(back, (x, y, z)):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), b)


def test_tensor_decode_masks_the_sign_bit():
    # codes with bit 31 set are negative int32 patterns: every right shift
    # is masked, so they decode as the uint32 codes do
    rng = np.random.default_rng(4)
    codes = rng.integers(1 << 31, 1 << 32, 1000, dtype=np.uint64).astype(np.uint32)
    ours = morton.morton_decode(torch.from_numpy(codes.view(np.int32)))
    ref = jax_morton.morton_decode(codes, xp=np)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), b)


def test_known_values():
    one, zero = np.uint32(1), np.uint32(0)
    assert int(morton.morton_encode(one, zero, zero)) == 1
    assert int(morton.morton_encode(zero, one, zero)) == 2
    assert int(morton.morton_encode(zero, zero, one)) == 4
    assert int(morton.morton_encode(*(np.uint32(3),) * 3)) == 63


@pytest.mark.parametrize("dtype", [np.uint64, np.int64])
def test_encode64_matches_jax_and_round_trips(dtype):
    x, y, z = _coords(5, 2000, 21, dtype)
    ours = morton.morton_encode64(x, y, z)
    ref = jax_morton.morton_encode64(x, y, z)
    assert ours.dtype == ref.dtype == np.uint64
    np.testing.assert_array_equal(ours, ref)
    dec = morton.morton_decode64(ours)
    for a, b, c in zip(dec, jax_morton.morton_decode64(ref), (x, y, z)):
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c.astype(np.int64))


def test_encode64_tensor_path_matches_the_reference():
    """The 64-bit encoder on int64 tensors (21 bits an axis, the top
    included) gives the reference's uint64 codes as int64 values."""
    x, y, z = _coords(6, 2000, 21, np.int64)
    got = morton.morton_encode64(*(torch.from_numpy(a) for a in (x, y, z)))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  jax_morton.morton_encode64(x, y, z))


def test_morton_order_is_parent_major():
    x, y, z = np.meshgrid(np.arange(4), np.arange(4), np.arange(4),
                          indexing="ij")
    codes = morton.morton_encode(*(c.ravel() for c in (x, y, z)))
    parents = morton.morton_encode(*((c // 2).ravel() for c in (x, y, z)))
    np.testing.assert_array_equal(codes >> np.uint32(3), parents)
