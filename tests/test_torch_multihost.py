"""Multi-process start-up and each process's rays
(``parallel/multihost.py``), against the JAX package's.

``init_from_env`` runs one process unless a coordinator is configured
(JAX_COORDINATOR_ADDRESS, or RAYT_MULTIHOST=auto with torchrun's
variables), as the reference's does. The two-process run is the twin of
``tests/test_multihost_integration.py``: two spawned processes start one
gloo world from the environment (rank 0 through JAX_COORDINATOR_ADDRESS,
rank 1 through RAYT_MULTIHOST=auto, one store), each renders only its own
rows, and the union of their rows equals the one-process render (the
port's bit for bit, the reference's to atol 1e-6, as its own test).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

from raytracingtest_tpu import diff as jax_diff
from raytracingtest_tpu.ops import octree as jax_octree
from raytracingtest_tpu.ops.camera import Camera as JaxCamera
from raytracingtest_tpu.parallel import multihost as jax_multihost
from raytracingtest_tpu.scenes import get_scene as jax_get_scene

from raytracingtest_tpu_torch import diff
from raytracingtest_tpu_torch.ops.camera import Camera
from raytracingtest_tpu_torch.ops.octree import build_svo
from raytracingtest_tpu_torch.parallel import multihost
from raytracingtest_tpu_torch.parallel.mesh import make_mesh
from raytracingtest_tpu_torch.scenes import get_scene
from tests import torch_ranks
from tests.test_torch_threads import one_torch_thread  # noqa: F401

CAM = dict(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5), fov_y_deg=50.0)
LIGHT = (-0.5, -1.0, -0.3)
SIZE = 32
# a small fit: depth 4, 64x64 views, so the tile step trains (8 tiles a rank)
FIT = ("fit", "--scene", "sphere", "--depth", "4", "--views", "2",
       "--view-resolution", "64", "--steps", "3")
ENV_VARS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
            "RAYT_MULTIHOST", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


@pytest.fixture
def clean_env(monkeypatch):
    for var in ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    """Both ranks' results of the two-process render."""
    port = str(torch_ranks.free_port())
    rank_env = {
        0: {"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "JAX_NUM_PROCESSES": "2",
            "JAX_PROCESS_ID": "0", "RAYT_MULTIHOST": ""},
        1: {"RAYT_MULTIHOST": "auto", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port,
            "WORLD_SIZE": "2", "RANK": "1", "JAX_COORDINATOR_ADDRESS": ""},
    }
    cache = tmp_path_factory.mktemp("cache")
    inputs = {"size": SIZE, "camera": CAM, "light": LIGHT, "fit": FIT,
              "cache": str(cache), "out": str(cache / "two")}
    return torch_ranks.run(2, "multihost", inputs, rank_env=rank_env), cache


def test_init_single_host_noop(clean_env):
    info = multihost.init_from_env()
    assert info == jax_multihost.init_from_env()
    assert info["initialized"] is False and info["process_count"] == 1
    assert not dist.is_initialized()


@pytest.mark.parametrize("value", ["1", "tpu", "off"])
def test_init_other_rayt_multihost_values_run_one_process(clean_env, value):
    """Only "auto" (or a coordinator) starts a world; any other value of
    RAYT_MULTIHOST runs one process, as the reference's does."""
    clean_env.setenv("RAYT_MULTIHOST", value)
    info = multihost.init_from_env(verbose=True)
    assert info == jax_multihost.init_from_env(verbose=True)
    assert info["process_count"] == 1 and not dist.is_initialized()


def test_init_with_a_coordinator_and_no_card_raises(clean_env):
    """A coordinator with no device named and no card: an error before any
    rendezvous, never a silent CPU world."""
    clean_env.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    clean_env.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.init_from_env()
    assert not dist.is_initialized()


def test_two_process_world_from_the_environment(two_processes):
    for rank, res in enumerate(two_processes[0]):
        assert res["info"] == {"initialized": True, "process_index": rank,
                               "process_count": 2, "local_devices": 1,
                               "global_devices": 2}
        assert (res["rank"], res["world"]) == (rank, 2)


def test_two_process_render_matches_single(two_processes):
    svo = build_svo(get_scene("sphere"), 4).svo
    o, d = Camera(**CAM, width=SIZE, height=SIZE).rays("cpu")
    ours = diff.render_diff(svo.leaf_albedo, svo.leaf_normal, svo.leaf_density,
                            svo, o, d, torch.tensor(LIGHT)).numpy()
    got = np.full_like(ours, np.nan)
    for res in two_processes[0]:
        got[res["start"]:res["start"] + res["rows"].shape[0]] = res["rows"]
    assert not np.isnan(got).any(), "missing output rows"
    np.testing.assert_array_equal(got, ours)

    ref_svo = jax_octree.build_svo(jax_get_scene("sphere"), 4).svo.device()
    ro, rd = JaxCamera(**CAM, width=SIZE, height=SIZE).rays(np)
    ref = np.asarray(jax_diff.render_diff(
        jnp.asarray(ref_svo.leaf_albedo), jnp.asarray(ref_svo.leaf_normal),
        jnp.asarray(ref_svo.leaf_density), ref_svo.masks, ref_svo.child_base,
        ref_svo.leaf_base, jnp.asarray(ro), jnp.asarray(rd), ref_svo.depth,
        jnp.asarray(LIGHT, jnp.float32)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_fit_across_two_processes_matches_one(two_processes, clean_env):
    """``fit`` in a world of two: each process trains on its rows, the
    printed losses are the one-process fit's, and process 0's checkpoint
    holds its parameters to atol 1e-5 (gradients summed by an all_reduce,
    F4, then three Adam steps)."""
    import contextlib
    import io
    import re

    from raytracingtest_tpu_torch import cli
    from raytracingtest_tpu_torch.io import checkpoint as ckpt

    results, cache = two_processes
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        cli.main(["--cache-dir", str(cache), "--device", "cpu", *FIT,
                  "--out-dir", str(cache / "one")])
    losses = lambda text: re.findall(r"loss ([0-9.e+-]+)  residual (\d+)", text)
    assert len(losses(err.getvalue())) == 3
    for res in results:
        assert losses(res["fit_log"]) == losses(err.getvalue())
        assert "WARNING" not in res["fit_log"]
    assert (cache / "two" / "fit_state.npz").exists()
    two, _, step2 = ckpt.load_train_state(str(cache / "two" / "fit_state.npz"),
                                          device="cpu")
    one, _, step1 = ckpt.load_train_state(str(cache / "one" / "fit_state.npz"),
                                          device="cpu")
    assert step1 == step2 == 3
    for name in ("albedo", "normal", "density"):
        np.testing.assert_allclose(two[name].numpy(), one[name].numpy(), rtol=0, atol=1e-5)


def test_process_rows_partition():
    prs = [multihost.process_rows(64, 32, process_index=i, process_count=4)
           for i in range(4)]
    assert [p.row_start for p in prs] == [0, 16, 32, 48]
    assert all(p.n_local == 16 * 32 for p in prs)
    refs = [jax_multihost.process_rows(64, 32, process_index=i, process_count=4)
            for i in range(4)]
    assert [dataclasses.astuple(p) for p in prs] == [dataclasses.astuple(r) for r in refs]
    with pytest.raises(ValueError):
        multihost.process_rows(65, 32, process_index=0, process_count=4)
    # no world started: this process is the only one
    assert multihost.process_rows(16, 8) == multihost.ProcessRays(0, 16, 16, 8)


def test_local_rays_tile_the_image():
    cam = Camera(**CAM, width=16, height=16)
    o_full, d_full = cam.rays("cpu")
    parts = [multihost.local_camera_rays(
        cam, multihost.process_rows(16, 16, process_index=i, process_count=4), "cpu")
        for i in range(4)]
    assert torch.equal(torch.cat([p[0] for p in parts]), o_full)
    assert torch.equal(torch.cat([p[1] for p in parts]), d_full)
    ref_o, _ = JaxCamera(**CAM, width=16, height=16).rays(np)
    np.testing.assert_array_equal(o_full.numpy(), ref_o)


def test_global_ray_array_single_process():
    cam = Camera(**CAM, width=16, height=16)
    pr = multihost.process_rows(16, 16, process_index=0, process_count=1)
    o, _d = multihost.local_camera_rays(cam, pr, "cpu")
    try:
        mesh = make_mesh(1, "cpu")
        arr = multihost.global_ray_array(mesh, pr, o)
        assert arr.shape == (256, 3) and torch.equal(arr, o)
        # rows that are not this rank's shard are refused
        with pytest.raises(ValueError):
            multihost.global_ray_array(
                mesh, multihost.process_rows(16, 16, process_index=1,
                                             process_count=2), o[:128])
    finally:
        dist.destroy_process_group()
