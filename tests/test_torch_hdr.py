"""The port's Radiance .hdr I/O against the JAX package's: files written by
either package identical and read alike by both, the RLE decoders on
hand-built files, and the baked sky bitwise."""

import numpy as np
import pytest

from raytracingtest_tpu.io import hdr as jax_hdr

from raytracingtest_tpu_torch.io import hdr
from tests.test_torch_threads import one_torch_thread  # noqa: F401


def _image(seed, h=21, w=37):
    rng = np.random.default_rng(seed)
    img = (rng.random((h, w, 3), dtype=np.float32) ** 2) * 300.0
    img[0, 0] = 0.0
    img[3, 4] = (1e-4, 50.0, 0.3)
    img[2, :5] = 1.5 / 256          # pixels that encode as (1, 1, 1, E)
    return img


@pytest.mark.parametrize("seed", [0, 1])
def test_files_identical_both_ways(tmp_path, seed):
    img = _image(seed)
    ours, ref = str(tmp_path / "ours.hdr"), str(tmp_path / "ref.hdr")
    hdr.save_hdr(ours, img)
    jax_hdr.save_hdr(ref, img)
    assert open(ours, "rb").read() == open(ref, "rb").read()
    for path in (ours, ref):
        a, b = hdr.load_hdr(path), jax_hdr.load_hdr(path)
        assert a.dtype == b.dtype == np.float32
        assert a.tobytes() == b.tobytes()


def _rle_file(path, w, h, new_style):
    if new_style:
        payload = b""
        for _ in range(h):
            payload += bytes([2, 2, w >> 8, w & 0xFF])
            payload += bytes([128 + w, 10])                 # R: a run
            payload += bytes([w]) + bytes(range(w))         # G: literals
            payload += bytes([128 + w, 7])                  # B: a run
            payload += bytes([128 + w, 128])                # E: a run
    else:
        px = bytes([200, 100, 50, 130])
        payload = (px + bytes([1, 1, 1, w - 1])) * h        # old-style repeat
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                + f"+Y {h} +X {w}\n".encode() + payload)


@pytest.mark.parametrize("new_style", [True, False])
def test_rle_decode_matches(tmp_path, new_style):
    path = str(tmp_path / "rle.hdr")
    _rle_file(path, 16, 3, new_style)
    a, b = hdr.load_hdr(path), jax_hdr.load_hdr(path)
    assert a.shape == (3, 16, 3)
    assert a.tobytes() == b.tobytes()


def test_rejects_what_the_reference_rejects(tmp_path):
    bad = tmp_path / "x.hdr"
    bad.write_bytes(b"P6\n1 1\n255\n\x00\x00\x00")
    xyze = tmp_path / "xyze.hdr"
    xyze.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n-Y 1 +X 1\n\x80\x80\x80\x80")
    for path in (bad, xyze):
        with pytest.raises(ValueError):
            hdr.load_hdr(str(path))
        with pytest.raises(ValueError):
            jax_hdr.load_hdr(str(path))
    with pytest.raises(ValueError):
        hdr.save_hdr(str(tmp_path / "y.hdr"), np.zeros((4, 4), np.float32))


@pytest.mark.parametrize("kw", [{}, dict(height=33, width=70, sun_dir=(1, 2, 3),
                                         sun_radiance=5.0, sun_cos=0.99)])
def test_make_sky_hdr_bitwise(kw):
    ours, ref = hdr.make_sky_hdr(**kw), jax_hdr.make_sky_hdr(**kw)
    assert ours.dtype == ref.dtype == np.float32
    assert ours.tobytes() == ref.tobytes()
    assert ours.max() > 1.0  # the sun disc is HDR
