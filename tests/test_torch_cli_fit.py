"""The port's `fit` and `debug` commands against the JAX package's, on the
CPU, and the `render` branches the other file leaves out: the printed fit
losses, the fit's state read by both packages, the debug probe's text and
overlay pixels, the LOD render's stackless route and a Radiance skybox
file. Small sizes: sphere at depth 3 to 5, images of 32x32 to 64x64."""

import io
import contextlib
import re

import numpy as np
import pytest
import torch
from PIL import Image

from raytracingtest_tpu import cli as jax_cli
from raytracingtest_tpu.io import checkpoint as jax_ckpt

from raytracingtest_tpu_torch import cli
from raytracingtest_tpu_torch.io import checkpoint as ckpt
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


def _losses(err):
    return [float(v) for v in re.findall(r"loss ([0-9.e+-]+)", err)]


@pytest.mark.parametrize("depth,res", [(3, 32), (4, 64)])
def test_fit_losses_match_jax(tmp_path, cache, depth, res):
    """Three steps from the same random albedo: depth 3 trains through the
    stackless step, depth 4 through the tile step (64x64: the reference
    shards the view's 16 tiles over the test mesh's 8 CPU devices). The printed losses (4
    significant digits) agree within 2e-3 relative, the final albedo error
    within 1e-3 absolute."""
    argv = ("fit", "--scene", "sphere", "--depth", str(depth), "--views", "4",
            "--view-resolution", str(res), "--steps", "3")
    _, ours = port(cache, *argv, "--out-dir", str(tmp_path / "ours"))
    _, theirs = ref(cache, *argv, "--out-dir", str(tmp_path / "ref"))
    a, b = _losses(ours), _losses(theirs)
    assert len(a) == len(b) == 3
    np.testing.assert_allclose(a, b, rtol=2e-3)
    assert a[2] < a[0]
    err = lambda text: float(re.search(r"albedo error\| = ([0-9.]+)", text).group(1))
    assert abs(err(ours) - err(theirs)) <= 1e-3
    assert f"synthesized 4 posed target views at {res}x{res}" in ours
    assert "residual 0" in ours and "WARNING" not in ours
    # the state: step and parameters read by both packages
    path = str(tmp_path / "ours" / "fit_state.npz")
    params, opt, step = ckpt.load_train_state(path, device="cpu")
    jparams, _jopt, jstep = jax_ckpt.load_train_state(path)
    assert step == jstep == 3 and opt is None
    for name in ("albedo", "normal", "density"):
        np.testing.assert_array_equal(params[name].numpy(), jparams[name])
    np.testing.assert_allclose(
        params["albedo"].numpy(),
        jax_ckpt.load_train_state(str(tmp_path / "ref" / "fit_state.npz"))[0]["albedo"],
        atol=1e-5)
    # and the port's Adam state goes back into a fresh optimizer
    template = torch.optim.Adam([torch.zeros_like(params["albedo"])], lr=5e-2)
    _p, restored, _s = ckpt.load_train_state(path, template, device="cpu")
    assert restored is template
    assert float(next(iter(template.state.values()))["step"]) == 3.0


def test_debug_matches_jax(tmp_path, cache):
    argv = ("debug", "--scene", "sphere", "--depth", "5", "--level", "2",
            "--ray", "0.1", "0.9", "0.1", "0.5", "-0.7", "0.5",
            "--width", "64", "--height", "48")
    ours, _ = port(cache, *argv, "--out", str(tmp_path / "ours.png"))
    theirs, _ = ref(cache, *argv, "--out", str(tmp_path / "ref.png"))
    # the probe's leaves equal; t printed to 6 decimals may part in the
    # last digit against XLA's contracted multiply-adds (test_torch_viz.py
    # holds t bitwise against the reference run without them)
    leaves = lambda text: re.findall(r"leaf +(\d+)", text)
    assert leaves(ours) == leaves(theirs) and leaves(ours)
    ts = lambda text: [float(v) for v in re.findall(r"t=([0-9.]+)", text)]
    np.testing.assert_allclose(ts(ours), ts(theirs), atol=2e-6)
    assert ours.splitlines()[-1] == theirs.splitlines()[-1].replace("ref.png", "ours.png")
    np.testing.assert_array_equal(pixels(tmp_path / "ours.png"),
                                  pixels(tmp_path / "ref.png"))


def test_render_lod_stackless_route_and_hdr_skybox(tmp_path, cache):
    """Below the brick depth the LOD render takes the stackless route; a
    Radiance file as the skybox reads without an imaging package."""
    from raytracingtest_tpu_torch.io import hdr
    sky = str(tmp_path / "sky.hdr")
    hdr.save_hdr(sky, hdr.make_sky_hdr(32, 64))
    for extra in (("--depth", "3", "--lod-coef", "0.05"), ("--skybox", sky)):
        argv = ("--scene", "sphere", "--depth", "4", "--width", "32", "--height",
                "32", *extra)
        port(cache, "render", *argv, "--out", str(tmp_path / "ours.png"))
        ref(cache, "render", *argv, "--out", str(tmp_path / "ref.png"))
        np.testing.assert_array_equal(pixels(tmp_path / "ours.png"),
                                      pixels(tmp_path / "ref.png"))
