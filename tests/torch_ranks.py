"""Worlds of gloo ranks on the CPU for the port's multi-rank tests.

``run(world, case, inputs)`` runs the case function `case` of this module
in every rank of a world of `world` ranks and returns each rank's result (a
dict of numpy arrays and numbers), in rank order. A world of one runs in
the calling process (``make_mesh`` starts it, and it is destroyed after);
a larger one is `world` processes of ``python -m tests.torch_ranks``, a
gloo world that meets in a ``FileStore`` of a temporary directory (no port
to race for with the other worlds of a parallel test run), each with one
torch thread. Inputs and results travel as pickles in the same directory.
The cases import the port only, never JAX, so a rank starts in seconds;
the test modules hold the results against the JAX package.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run(world: int, case: str, inputs: dict, rank_env=None, timeout=300):
    """Each rank's result of CASES[case](rank, world, inputs). `rank_env`
    (rank -> dict) adds variables to a spawned rank's environment; such a
    case starts its world itself."""
    if world == 1 and rank_env is None:
        try:
            return [CASES[case](0, 1, inputs)]
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
            pickle.dump(inputs, f)
        procs, logs = [], []
        try:
            for r in range(world):
                env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
                env.update((rank_env or {}).get(r, {}))
                logs.append(open(os.path.join(tmp, f"rank{r}.log"), "wb"))
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "tests.torch_ranks", case, str(r),
                     str(world), tmp],
                    cwd=_REPO, env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
            # wait for all; a rank that fails or a deadline ends the world,
            # so a rank left waiting for a dead peer does not hang the test
            deadline = time.monotonic() + timeout
            while (any(p.poll() is None for p in procs)
                   and not any(p.returncode for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for f in logs:
                f.close()
        if any(p.returncode for p in procs):
            # every rank's exit code and log: the first to fail may be a
            # victim of another
            report = []
            for r, p in enumerate(procs):
                with open(os.path.join(tmp, f"rank{r}.log"), "rb") as f:
                    out = f.read().decode(errors="replace")
                report.append(f"rank {r} ({p.returncode}):\n{out[-3000:]}")
            raise AssertionError("a rank failed:\n" + "\n".join(report))
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x)
    return x


def _shard(x, rank, world):
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n]


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def case_level_sharded(rank, world, inputs):
    """The level-sharded trace (replicated rays, with and without a small
    octant cap) and the exchange trace of the hotspot rays at each of
    inputs["hot_rounds"], on the depth-6 sphere split at level 2."""
    from raytracingtest_tpu_torch.ops.octree import build_svo
    from raytracingtest_tpu_torch.parallel import level_sharded as ls_mod
    from raytracingtest_tpu_torch.parallel.mesh import make_mesh
    from raytracingtest_tpu_torch.scenes import get_scene

    mesh = make_mesh(world, "cpu")
    ls = ls_mod.split_svo(build_svo(get_scene("sphere"), 6), 2, world)
    o, d = (torch.from_numpy(a) for a in inputs["rays"])
    out = {"trace": _np(ls_mod.make_sharded_trace(mesh, ls)(o, d)),
           "capped": _np(ls_mod.make_sharded_trace(mesh, ls, max_octants=2)(o, d))}
    ho, hd = (torch.from_numpy(_shard(a, rank, world)) for a in inputs["hot"])
    for mr in inputs["hot_rounds"]:
        trace = ls_mod.make_exchange_trace(mesh, ls, max_rounds=mr, cap_factor=1)
        out[f"hot{mr}"] = _np(trace(ho, hd))
    return out


def case_level_queued(rank, world, inputs):
    """The level-sharded loops twice: with each round through the plain
    model of kernel level_round's queued form (level_round_queued_plain:
    the queue, the round over the queued rays alone, the first form's
    outputs elsewhere) and through the unqueued plain version. The sharded
    trace of inputs["rays"] and the exchange trace of this rank's shard of
    inputs["hot"] at cap_factor 1, with their rounds."""
    from raytracingtest_tpu_torch.ops.octree import build_svo
    from raytracingtest_tpu_torch.parallel import level_sharded as ls_mod
    from raytracingtest_tpu_torch.parallel.mesh import make_mesh
    from raytracingtest_tpu_torch.scenes import get_scene

    mesh = make_mesh(world, "cpu")
    ls = ls_mod.split_svo(build_svo(get_scene("sphere"), 6), 2, world)
    o, d = (torch.from_numpy(a) for a in inputs["rays"])
    ho, hd = (torch.from_numpy(_shard(a, rank, world)) for a in inputs["hot"])
    out, unqueued = {}, ls_mod.level_round
    for name, rounds in (("queued", ls_mod.level_round_queued_plain),
                         ("unqueued", unqueued)):
        ls_mod.level_round = rounds
        try:
            trace = ls_mod.make_sharded_trace(mesh, ls)
            exchange = ls_mod.make_exchange_trace(mesh, ls, max_rounds=inputs["hot_rounds"],
                                                  cap_factor=1)
            out[name] = {"trace": _np(trace(o, d)), "trace_rounds": trace.stats["rounds"],
                         "exchange": _np(exchange(ho, hd)),
                         "exchange_rounds": exchange.stats["rounds"]}
        finally:
            ls_mod.level_round = unqueued
    return out


def case_level_train(rank, world, inputs):
    """The level-sharded fit step (this rank's loss and arena gradients)
    and the exchange trace of this rank's shard of inputs["xrays"]."""
    from raytracingtest_tpu_torch.ops.octree import build_svo
    from raytracingtest_tpu_torch.parallel import level_sharded as ls_mod
    from raytracingtest_tpu_torch.parallel.mesh import make_mesh
    from raytracingtest_tpu_torch.scenes import get_scene

    mesh = make_mesh(world, "cpu")
    ls = ls_mod.split_svo(build_svo(get_scene("sphere"), 6), 2, world)
    t = torch.from_numpy
    step = ls_mod.make_sharded_fit_step(mesh, ls, max_octants=6)
    o, d = (t(a) for a in inputs["frays"])
    loss, grads = step(t(ls.arena_albedo[rank]), t(ls.arena_normal[rank]),
                       t(ls.arena_density[rank]), o, d, t(inputs["light"]),
                       t(inputs["target"]))
    xo, xd = (t(_shard(a, rank, world)) for a in inputs["xrays"])
    trace = ls_mod.make_exchange_trace(mesh, ls, max_rounds=8, cap_factor=4)
    return {"loss": float(loss), "grads": _np(grads),
            "exchange": _np(trace(xo, xd)), "rounds": trace.stats["rounds"]}


def _adam(params, lr):
    return torch.optim.Adam([params["albedo"], params["normal"], params["density"]],
                            lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _grads_of(step, params, *args):
    """(loss and the rest, all-reduced gradients) of one sharded step: an
    SGD optimizer of learning rate 0 keeps the parameters and the .grad the
    step set."""
    opt = torch.optim.SGD([params["albedo"], params["normal"], params["density"]],
                          lr=0.0)
    out = step(params, opt, *args)
    return _np(out[2:]), _np([params[k].grad for k in ("albedo", "normal", "density")])


def case_sharding(rank, world, inputs):
    """The ray-sharded frames and steps: render_sharded, the three train
    steps (gradients with a still optimizer, parameters after one Adam
    step), the tile step in two groups and with starved budgets, the
    sharded tile render, and InverseRenderer(n_devices=world)."""
    from raytracingtest_tpu_torch.config import CameraConfig
    from raytracingtest_tpu_torch.models import InverseRenderer
    from raytracingtest_tpu_torch.ops import brick, tile
    from raytracingtest_tpu_torch.ops.octree import build_svo
    from raytracingtest_tpu_torch.parallel import render_sharded as rs
    from raytracingtest_tpu_torch.parallel.mesh import make_mesh, ray_sharding, replicated
    from raytracingtest_tpu_torch.scenes import get_scene

    mesh = make_mesh(world, "cpu")
    sh = lambda a: ray_sharding(mesh, torch.from_numpy(np.ascontiguousarray(a)))
    # rank 0's light on every rank
    light = replicated(mesh, torch.tensor(inputs["light"]) if rank == 0 else torch.zeros(3))
    out = {}

    def fresh(svo):
        return {"albedo": svo.leaf_albedo.clone(), "normal": svo.leaf_normal.clone(),
                "density": svo.leaf_density.clone()}

    # the sphere at depth 4: the stackless frame and step
    s4 = build_svo(get_scene("sphere"), 4).svo
    o, d, target = (sh(a) for a in inputs["sphere"])
    out["render"] = _np(rs.render_sharded(mesh, s4.leaf_albedo, s4.leaf_normal,
                                          s4.leaf_density, s4, o, d, light))
    out["step_grads"] = _grads_of(rs.make_train_step(mesh), fresh(s4), s4, o, d,
                                  light, target)
    p = fresh(s4)
    out["step_loss"] = _np(rs.make_train_step(mesh)(p, _adam(p, 1e-2), s4, o, d,
                                                    light, target)[2])
    out["step_params"] = _np(p)

    # the sphere at depth 5: the brick step against the stackless step
    s5 = build_svo(get_scene("sphere"), 5).svo
    b5 = brick.make_brick_svo(s5)
    o, d, target = (sh(a) for a in inputs["point"])
    for name, step, tree in (("plain", rs.make_train_step(mesh), s5),
                             ("brick", rs.make_train_step_brick(mesh), b5)):
        p = fresh(s5)
        out[f"{name}_loss"] = _np(step(p, _adam(p, 1e-2), tree, o, d, light, target)[2])
        out[f"{name}_params"] = _np(p)

    # terrain at depth 6: the tile frame and step (tile-major rays)
    t6 = build_svo(get_scene("terrain"), 6).svo
    ts6, bs6 = tile.make_tile_svo(t6), brick.make_brick_svo(t6)
    to, td, tc, tt = (sh(a) for a in inputs["tiles"])
    fo, fd = to.reshape(-1, 3), td.reshape(-1, 3)
    p = fresh(t6)
    out["flat_loss"] = _np(rs.make_train_step(mesh)(p, _adam(p, 1e-2), t6, fo, fd,
                                                    light, tt)[2])
    out["flat_params"] = _np(p)
    for name, kw in (("tile", dict(fb_tiles=16, fb_k=512)),
                     ("tile2", dict(fb_tiles=16, fb_k=512, overlap_groups=2)),
                     ("starved", dict(k_max=8, fb_tiles=16, fb_k=512))):
        p = fresh(t6)
        res = rs.make_train_step_tile(mesh, **kw)(p, _adam(p, 1e-2), ts6, to, td,
                                                  tc, light, tt)
        out[f"{name}_loss"], out[f"{name}_resid"] = _np(res[2]), _np(res[3])
        out[f"{name}_params"] = _np(p)
        out[f"{name}_grads"] = _grads_of(rs.make_train_step_tile(mesh, **kw),
                                         fresh(t6), ts6, to, td, tc, light, tt)
    p = fresh(t6)
    out["brick6_loss"] = _np(rs.make_train_step_brick(mesh)(
        p, _adam(p, 1e-2), bs6, fo, fd, light, tt)[2])
    out["brick6_params"] = _np(p)
    ro, rd, rc = (sh(a) for a in inputs["tiles128"])
    out["tile_render"] = _np(rs.render_tile_sharded(
        mesh, t6.leaf_albedo, t6.leaf_normal, t6.leaf_density, ts6, ro, rd, rc,
        light, fb_tiles=16, fb_k=64))

    # the model: two step_view (tile route) and two step (brick route)
    model = InverseRenderer(t6, optimize=("albedo",), n_devices=world, device="cpu")
    params, state = model.init_params(seed=0)
    view = CameraConfig(**inputs["view"])
    losses = []
    for _ in range(2):
        params, state, loss, resid = model.step_view(params, state, view,
                                                     inputs["light"],
                                                     inputs["view_target"])
        losses.append((float(loss), int(resid)))
    o, d, target = model.shard_rays(*(torch.from_numpy(a) for a in inputs["model_rays"]))
    for _ in range(2):
        params, state, loss = model.step(params, state, o, d, inputs["light"], target)
        losses.append((float(loss), 0))
    out["model_losses"] = losses
    out["model_params"] = _np(params)
    return out


def case_sharding_grads(rank, world, inputs):
    """The three sharded train steps' loss and all-reduced gradients (a
    still optimizer) on one tree, from the inputs' parameters: the
    stackless and the brick step on this rank's shard of the flat rays, the
    tile step on its shard of the tiles."""
    from raytracingtest_tpu_torch.ops import brick, tile
    from raytracingtest_tpu_torch.ops.octree import build_svo
    from raytracingtest_tpu_torch.parallel import render_sharded as rs
    from raytracingtest_tpu_torch.parallel.mesh import make_mesh, ray_sharding
    from raytracingtest_tpu_torch.scenes import get_scene

    mesh = make_mesh(world, "cpu")
    sh = lambda a: ray_sharding(mesh, torch.from_numpy(np.ascontiguousarray(a)))
    light = torch.tensor(inputs["light"])
    svo = build_svo(get_scene(inputs["scene"]), inputs["depth"]).svo
    bsvo, ts = brick.make_brick_svo(svo), tile.make_tile_svo(svo)
    params = lambda: dict(zip(("albedo", "normal", "density"),
                              (torch.from_numpy(a.copy()) for a in inputs["params"])))
    o, d, target = (sh(a) for a in inputs["flat"])
    to, td, tc, tt = (sh(a) for a in inputs["tiles"])
    return {
        "stackless": _grads_of(rs.make_train_step(mesh), params(), svo, o, d, light, target),
        "brick": _grads_of(rs.make_train_step_brick(mesh), params(), bsvo, o, d, light, target),
        "tile": _grads_of(rs.make_train_step_tile(mesh, **inputs["budgets"]), params(), ts,
                          to, td, tc, light, tt),
    }


def case_multihost(rank, world, inputs):
    """A process started from the environment (``init_from_env``) renders
    only its rows of the camera (``process_rows``, ``local_camera_rays``,
    ``global_ray_array``, ``render_sharded``), then, with inputs["fit"],
    runs the ``fit`` command in the same world."""
    from raytracingtest_tpu_torch.ops.camera import Camera
    from raytracingtest_tpu_torch.ops.octree import build_svo
    from raytracingtest_tpu_torch.parallel import multihost
    from raytracingtest_tpu_torch.parallel.mesh import make_mesh
    from raytracingtest_tpu_torch.parallel.render_sharded import render_sharded
    from raytracingtest_tpu_torch.scenes import get_scene

    info = multihost.init_from_env(verbose=False, device="cpu")
    mesh = make_mesh(device="cpu")
    svo = build_svo(get_scene("sphere"), 4).svo
    H = W = inputs["size"]
    cam = Camera(**inputs["camera"], width=W, height=H)
    pr = multihost.process_rows(H, W)
    o_l, d_l = multihost.local_camera_rays(cam, pr, "cpu")
    o = multihost.global_ray_array(mesh, pr, o_l)
    d = multihost.global_ray_array(mesh, pr, d_l)
    img = render_sharded(mesh, svo.leaf_albedo, svo.leaf_normal, svo.leaf_density,
                         svo, o, d, torch.tensor(inputs["light"]))
    out = {"info": info, "start": pr.row_start * W, "rows": _np(img),
           "world": mesh.world, "rank": mesh.rank}
    if "fit" in inputs:
        # the fit command in the same world: each process trains on its rows
        import contextlib
        import io

        from raytracingtest_tpu_torch import cli
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            cli.main(["--cache-dir", inputs["cache"], "--device", "cpu",
                      *inputs["fit"], "--out-dir", inputs["out"]])
        out["fit_log"] = err.getvalue()
    return out


CASES = {"level_sharded": case_level_sharded, "level_queued": case_level_queued,
         "level_train": case_level_train,
         "sharding": case_sharding, "sharding_grads": case_sharding_grads,
         "multihost": case_multihost}
# the cases that start their world from the environment
_FROM_ENV = {"multihost"}


def _main():
    case, rank, world, tmp = sys.argv[1:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    if case not in _FROM_ENV:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=120))
    result = CASES[case](rank, world, inputs)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    _main()
