"""The port's codecs (``raytracingtest_tpu_torch/ops/codecs.py``) against
the JAX package's, bit for bit: the host encoders and ``build_attachments``
on identical numpy inputs, the torch decoders on every 16-bit code and on
words whose high bits are set (where an int32 right shift is arithmetic).

Inputs come from numpy seeds; both packages see identical arrays."""

import numpy as np
import pytest
import torch

from raytracingtest_tpu.ops import codecs as jax_codecs
from raytracingtest_tpu.ops import octree as jax_octree
from raytracingtest_tpu.scenes import get_scene as jax_get_scene

from raytracingtest_tpu_torch import convert
from raytracingtest_tpu_torch.ops import codecs, octree
from raytracingtest_tpu_torch.scenes import get_scene
from tests.test_torch_threads import one_torch_thread  # noqa: F401


def words(a):
    """uint32 numpy words as the port carries them: int32 tensors."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def same_bits(ours, ref):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    assert ours.tobytes() == ref.astype(ours.dtype).tobytes()
    assert ours.itemsize == ref.itemsize


ALL_CODES = np.arange(1 << 16, dtype=np.uint32)
# the same codes with garbage above bit 15, bit 31 included: the decoders
# read their 16 bits only after masking
HIGH_CODES = ALL_CODES | (np.random.default_rng(5).integers(
    1, 1 << 16, ALL_CODES.shape).astype(np.uint32) << np.uint32(16))


def test_r5g6b5_matches_jax_bitwise():
    rng = np.random.default_rng(0)
    c = np.concatenate([rng.random((1000, 3), dtype=np.float32) * 1.2 - 0.1,
                        np.array([[0, 0, 0], [1, 1, 1]], np.float32)])
    same_bits(codecs.pack_r5g6b5(c), jax_codecs.pack_r5g6b5(c))
    same_bits(codecs.unpack_r5g6b5(words(ALL_CODES)),
              jax_codecs.unpack_r5g6b5(ALL_CODES))
    # bits 16-31 are not the colour's: JAX's uint32 decoder masks them off
    same_bits(codecs.unpack_r5g6b5(words(HIGH_CODES) & 0xFFFF),
              jax_codecs.unpack_r5g6b5(ALL_CODES))


def test_normal16_matches_jax_bitwise():
    rng = np.random.default_rng(1)
    n = rng.normal(size=(2000, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n = np.concatenate([n, np.eye(3, dtype=np.float32), -np.eye(3, dtype=np.float32)])
    same_bits(codecs.pack_normal16(n), jax_codecs.pack_normal16(n))
    same_bits(codecs.unpack_normal16(words(ALL_CODES)),
              jax_codecs.unpack_normal16(ALL_CODES))
    same_bits(codecs.unpack_normal16(words(HIGH_CODES)),
              jax_codecs.unpack_normal16(HIGH_CODES))


def test_child_palette_matches_jax_bitwise():
    rng = np.random.default_rng(2)
    colors = rng.random((500, 8, 3), dtype=np.float32)
    valid = rng.random((500, 8)) < 0.6
    valid[::7] = False       # nodes with no valid child
    valid[3::7, 5] = True    # nodes with one
    ours = codecs.encode_child_palette(colors, valid)
    ref = jax_codecs.encode_child_palette(colors, valid)
    for a, b in zip(ours, ref):
        same_bits(a, b)
    slots = rng.integers(0, 8, 500).astype(np.int32)
    got = codecs.decode_child_palette(*(words(w) for w in ours),
                                      torch.from_numpy(slots))
    same_bits(got, jax_codecs.decode_child_palette(*ref, slots.astype(np.uint32)))
    # every code of the palette words, in every slot
    ca, cb = ALL_CODES, ALL_CODES[::-1].copy()
    for slot in range(8):
        got = codecs.decode_child_palette(
            words(ca), words(cb), words(HIGH_CODES) & 0xFFFF,
            torch.full((ca.shape[0],), slot, dtype=torch.int32))
        same_bits(got, jax_codecs.decode_child_palette(
            ca, cb, ALL_CODES, np.uint32(slot)))


@pytest.mark.parametrize("name,depth", [("sphere", 5), ("terrain", 6),
                                        ("flat_ground", 4)])
def test_build_attachments_matches_jax_bitwise(name, depth):
    ours = octree.build_svo(get_scene(name), depth).svo
    ref = jax_octree.build_svo(jax_get_scene(name), depth).svo
    wa, wb = codecs.build_attachments(ours)
    ref_a, ref_b = jax_codecs.build_attachments(ref)
    assert wa.dtype == wb.dtype == torch.int32
    same_bits(wa.numpy().view(np.uint32), ref_a)
    same_bits(wb.numpy().view(np.uint32), ref_b)
    # the reference's words, moved into the port, carry the same bits
    ca, cb = convert.attachments_from_numpy(ref_a, ref_b, "cpu")
    assert torch.equal(ca, wa) and torch.equal(cb, wb)
    # other leaf arrays than the SVO's own
    rng = np.random.default_rng(depth)
    alb = rng.random((ours.n_leaves, 3), dtype=np.float32)
    wa2, _wb2 = codecs.build_attachments(ours, leaf_albedo=torch.from_numpy(alb))
    same_bits(wa2.numpy().view(np.uint32),
              jax_codecs.build_attachments(ref, leaf_albedo=alb)[0])


@pytest.mark.parametrize("name,depth", [("sphere", 5), ("terrain", 6)])
def test_esvo_descriptors_match_jax(name, depth):
    ours = octree.build_svo(get_scene(name), depth).svo
    ref = jax_octree.build_svo(jax_get_scene(name), depth).svo
    packed = codecs.pack_esvo_descriptors(ours)
    same_bits(packed, jax_codecs.pack_esvo_descriptors(ref))
    back = codecs.unpack_esvo_descriptors(packed, ours.level_start, depth)
    for a, b, t in zip(back, jax_codecs.unpack_esvo_descriptors(
            packed, ref.level_start, depth),
            (ours.masks, ours.child_base, ours.leaf_base)):
        same_bits(a, b)
        assert np.array_equal(a, t.numpy())
