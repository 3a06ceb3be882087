"""The port's command line against the JAX package's, on the CPU: `info`
text equal, `render`'s PNG pixels equal on every branch, the build cache
shared between the two packages, the PNG writer, and the refusal to run
without a device. Small sizes: sphere at depth 4, 32x32 images."""

import io
import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from raytracingtest_tpu import cli as jax_cli

from raytracingtest_tpu_torch import cli
from tests.test_torch_threads import one_torch_thread  # noqa: F401


def run(main, argv):
    """(stdout, stderr) of one command."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(argv)
    return out.getvalue(), err.getvalue()


def port(cache, *argv):
    return run(cli.main, ["--cache-dir", str(cache), "--device", "cpu", *argv])


def ref(cache, *argv):
    return run(jax_cli.main, ["--cache-dir", str(cache), *argv])


def pixels(path):
    return np.asarray(Image.open(path))


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("cache")


SMALL = ("--scene", "sphere", "--depth", "4", "--width", "32", "--height", "32")


# every branch of `render`; the default and --skybox average float32
# images (one sample and three), and every PNG comes out equal pixel for
# pixel to the JAX command's
@pytest.mark.parametrize("branch", [
    (), ("--samples", "3"), ("--volumetric-k", "2"), ("--attachments",),
    ("--lod-coef", "0.05"), ("--specular", "0.5", "--bounces", "3"),
    ("--skybox", "procedural"),
], ids=["default", "samples3", "volumetric", "attachments", "lod", "bounce",
        "skybox"])
def test_render_png_equals_jax(tmp_path, cache, branch):
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "ref.png")
    port(cache, "render", *SMALL, *branch, "--out", ours)
    ref(cache, "render", *SMALL, *branch, "--out", theirs)
    a, b = pixels(ours), pixels(theirs)
    assert a.shape == (32, 32, 3) and a.dtype == np.uint8
    assert a.std() > 1.0  # not a constant image
    np.testing.assert_array_equal(a, b)


def test_render_skybox_refusals(tmp_path, cache):
    with pytest.raises(SystemExit, match="--skybox combines only"):
        port(cache, "render", *SMALL, "--skybox", "procedural", "--attachments",
             "--out", str(tmp_path / "x.png"))


def test_info_text_equals_jax(tmp_path, cache):
    ours, _ = port(cache, "info", "--scene", "terrain", "--depth", "5")
    theirs, _ = ref(cache, "info", "--scene", "terrain", "--depth", "5")
    assert ours == theirs
    assert "level  4" in ours and ours.startswith("scene=terrain depth=5\n")
    # --load of a saved checkpoint
    from raytracingtest_tpu_torch.io import checkpoint
    from raytracingtest_tpu_torch.ops import octree
    from raytracingtest_tpu_torch.scenes import get_scene
    path = str(tmp_path / "perlin_d5.npz")
    checkpoint.save_svo(octree.build_svo(get_scene("perlin"), 5).svo, path)
    ours, _ = port(cache, "info", "--load", path)
    theirs, _ = ref(cache, "info", "--load", path)
    assert ours == theirs and ours.startswith(f"scene={path} depth=5")


def test_build_cache_shared_between_packages(tmp_path):
    _, err = ref(tmp_path, "info", "--scene", "simplex_ref", "--depth", "4")
    assert "built simplex_ref" in err
    _, err = port(tmp_path, "info", "--scene", "simplex_ref", "--depth", "4")
    assert "built" not in err      # the JAX package's cache file served
    _, err = port(tmp_path, "info", "--scene", "perlin", "--depth", "4")
    assert "built perlin" in err
    _, err = ref(tmp_path, "info", "--scene", "perlin", "--depth", "4")
    assert "built" not in err      # and the port's serves the JAX package
    assert sorted(os.listdir(tmp_path)) == ["svo_perlin_d4.npz",
                                            "svo_simplex_ref_d4.npz"]


def test_png_writer_decodes_to_its_pixels(tmp_path):
    rng = np.random.default_rng(0)
    for shape in ((7, 13, 3), (1, 1, 3), (40, 3, 3)):
        px = rng.integers(0, 256, shape, dtype=np.uint8)
        path = tmp_path / "x.png"
        path.write_bytes(cli.png_bytes(px))
        img = Image.open(path)
        assert img.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(img), px)
    img = torch.tensor([[[-1.0, 0.5, 2.0]]])
    np.testing.assert_array_equal(cli.to_pixels(img), [[[0, 127, 255]]])
    with pytest.raises(ValueError):
        cli.png_bytes(np.zeros((2, 2, 4), np.uint8))


def test_without_a_device_it_stops(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(SystemExit, match="no CUDA device is available"):
        cli.main(["--cache-dir", str(tmp_path), "info", "--scene", "sphere",
                  "--depth", "3"])
    assert not os.listdir(tmp_path)   # it stopped before any work


def test_module_runs_as_a_program(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "x.png"
    proc = subprocess.run(
        [sys.executable, "-m", "raytracingtest_tpu_torch.cli", "--device", "cpu",
         "--cache-dir", str(tmp_path), "render", "--scene", "terrain_ref",
         "--depth", "5", "--width", "64", "--height", "64", "--out", str(out)],
        cwd=root, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    img = pixels(out)
    assert img.shape == (64, 64, 3)
    sky = np.all(img == img[0, 0], axis=-1)   # the top row is sky
    assert 0 < sky.sum() < 64 * 64
