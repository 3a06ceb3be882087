"""Phase 1 of the streamed world by form, on one NVIDIA GPU, in a process of
its own.

    env PYTHONPATH=. python3 cand_probe.py [FORM ...]

Streams chip_smoke.py's parity world (the whole `terrain` world at depth
10, FLY_PARITY) and traces its 1024² tile frame through bench.py's camera at
bench.py's budgets, then flies cli fly's camera path (FLY_TIMING) to its
first frame with chunks of both LODs, and records the brickmap-mode phase-1
calls of both frames: three, then six. Each call, in each FORM (of
``tile_cuda.CANDIDATE_FORMS``; all by default), and the parity frame's main
call also unmapped, goes through ``chip_smoke.cand_forms``: the form and its
probe form held bitwise against ``candidates_plain`` + ``remap_ids``, its
[cand-warps] line, and the forms' times in turns and alone beside the call's
bound. chip_smoke.py's [fly] runs the same on the same calls.
"""

import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
from raytracingtest_tpu_torch import _build
from raytracingtest_tpu_torch.models import StreamingRenderer
from raytracingtest_tpu_torch.ops import camera, tile, tile_cuda
from raytracingtest_tpu_torch.scenes import get_scene
from raytracingtest_tpu_torch.stream import clipmap

BENCH_CAM = dict(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5), fov_y_deg=50.0)
RES = 1024


def world_calls(dev):
    """(calls, names): the streamed parity frame's three phase-1 calls and
    fly frame 0's six (the first frame of cli fly's path with both LODs),
    as ((args, kw) of tile_cuda.candidates, name)."""
    scene = get_scene("terrain")
    budgets = {k: cs.TILE_BUDGETS[k] for k in ("k_max", "fb_tiles", "fb_k", "fb2_tiles")}
    clip, dev_a, dev_b = cs.fly_world(scene, dev, **cs.FLY_PARITY)
    clip.update((0.5, 0.5, 0.5))
    dev_a.sync()
    dev_b.sync()
    masters = [m.to(dev) for m in clip.master_tile()]
    o, d, corners, _grid = tile.tile_rays(
        camera.Camera(**BENCH_CAM, width=RES, height=RES), dev)
    with cs.mapped_calls() as parity:
        clipmap.trace_clipmap_tile(masters, dev_b, o, d, corners, **budgets)
    del clip, dev_a, dev_b
    sr = StreamingRenderer(scene, node_capacity=cs.FLY_ARENA[0],
                           leaf_capacity=cs.FLY_ARENA[1], device=dev, **cs.FLY_TIMING)
    for f, (pos, look) in enumerate(cs.fly_poses(cs.FLY_FRAMES, cs.FLY_HOLD)):
        sr.update(np.asarray(pos))
        fcam = camera.Camera(position=pos, look_at=look, fov_y_deg=55.0, width=RES,
                             height=RES)
        if len({c.size for c in sr.clipmap.resident.values()}) > 1:
            with cs.mapped_calls() as fly:
                sr.render(fcam, fetch=False)
            torch.cuda.synchronize()
            names = ([f"parity {c}" for c in cs.CAND_CALLS]
                     + [f"fly frame {f} LOD {i} {c}" for i in range(len(sr._masters))
                        for c in cs.CAND_CALLS])
            return parity + fly, names
        sr.render(fcam, fetch=False)
    raise AssertionError("no frame of cli fly's path held chunks of both LODs")


def main(forms):
    if not torch.cuda.is_available():
        raise SystemExit("cand_probe: torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    cs.say(card)
    _build.candidates_lib()
    cs.say("[build] tile_candidates.cu, ptxas -v: " + "; ".join(
        f"{k} {r} regs, {sp} spilled, {sm} B shared"
        for k, r, sp, sm in cs.ptxas_report(_build.build_log("tile_candidates"))))
    err = {}
    cams = [camera.Camera(**cam, width=128, height=128) for cam in (
        BENCH_CAM, dict(position=(0.5, 0.05, 0.5), look_at=(0.5, 0.5, 0.5), fov_y_deg=60.0),
        dict(position=(0.5, 0.5, -0.3), look_at=(0.5, 0.5, 1.0), fov_y_deg=50.0))]
    cases = cs.candidate_cases(dev, *cams)
    for what, args in cases:
        cs.check_candidates(args, what)
    cs.say(f"[parity] both forms of phase 1, unmapped and in the brickmap mode, at each "
           f"warps a tile == candidates_plain (+ remap_ids) bitwise on {len(cases)} "
           "small cases")
    calls, names = world_calls(dev)
    variants = {k: v for k, v in cs.CAND_VARIANTS.items() if v["form"] in forms}
    cs.cand_forms(calls, names, variants, card, err)
    cs.cand_forms([(calls[0][0], {})], ["parity main, unmapped"], variants, card, err)


if __name__ == "__main__":
    main(tuple(sys.argv[1:]) or tile_cuda.CANDIDATE_FORMS)
