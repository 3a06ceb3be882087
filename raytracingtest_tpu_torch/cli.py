"""The command line: render / fit / fly / info / debug / probe.

Port of ``raytracingtest_tpu/cli.py``, with the same subcommands, arguments
and defaults, and one more global option, ``--device``: the card
(``cuda:0``) by default, which stops with an error where there is none; pass
``--device cpu`` to run the plain versions on the CPU.

  python -m raytracingtest_tpu_torch.cli render --scene terrain --depth 8 \\
      --width 512 --height 512 --out out.png
  python -m raytracingtest_tpu_torch.cli fit --scene sphere --depth 6 \\
      --views 16 --steps 100 --out-dir /tmp/fit
  python -m raytracingtest_tpu_torch.cli info --scene sphere --depth 6
  python -m raytracingtest_tpu_torch.cli --device cpu debug --ray \\
      0.1 0.9 0.1 0.5 -0.7 0.5 --out boxes.png
  python -m raytracingtest_tpu_torch.cli fly --resolution 1024 --path tile
  python -m raytracingtest_tpu_torch.cli probe --commands \\
      "from 0.5 0.95 0.5; to 0.5 0.05 0.5; render probe.png; quit"

Builds are cached on disk by (scene, depth) under the JAX package's file
names; builds are byte-identical in both packages, so one cache serves
both. PNGs are written with the standard library (8-bit RGB), so rendering
needs no imaging package; ``--skybox`` reads a Radiance ``.hdr`` or the
procedural sky without one, and other image files through Pillow where it
is installed. ``fly`` drives the streamed world (``models.StreamingRenderer``;
``--path brick`` the per-ray stitched trace); ``probe`` is the headless
probe session, its commands from stdin or ``--commands``.
"""

from __future__ import annotations

import argparse
import os
import struct
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

from raytracingtest_tpu_torch._device import resolve

_LIGHT = (-0.5, -1.0, -0.3)


def _load_or_build(scene_name: str, depth: int, cache_dir: str,
                   load: str = ""):
    """The SVO of `load` (an npz checkpoint), else of (scene, depth) from
    the cache, else built and cached. Its tensors lie on the CPU."""
    from raytracingtest_tpu_torch.io import checkpoint as ckpt
    from raytracingtest_tpu_torch.ops.octree import build_svo
    from raytracingtest_tpu_torch.scenes import get_scene

    if load:
        return ckpt.load_svo(load, "cpu")
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"svo_{scene_name}_d{depth}.npz")
    if os.path.exists(path):
        return ckpt.load_svo(path, "cpu")
    t0 = time.time()
    svo = build_svo(get_scene(scene_name), depth).svo
    print(f"built {scene_name} depth={depth}: {svo.n_nodes} nodes, "
          f"{svo.n_leaves} leaves in {time.time()-t0:.1f}s", file=sys.stderr)
    ckpt.save_svo(svo, path)
    return svo


def png_bytes(pixels: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 image as an 8-bit RGB PNG: one IDAT chunk of
    unfiltered scanlines (filter type 0), zlib-compressed."""
    pixels = np.ascontiguousarray(pixels, np.uint8)
    h, w, c = pixels.shape
    if c != 3:
        raise ValueError(f"expected (H, W, 3) pixels, got {pixels.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           pixels.reshape(h, w * 3)], axis=1)

    def chunk(kind, data):
        body = kind + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def to_pixels(img) -> np.ndarray:
    """A float image (tensor or array) as the PNG's uint8 pixels."""
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _save_png(img, path: str):
    with open(path, "wb") as f:
        f.write(png_bytes(to_pixels(img)))
    print(f"wrote {path}", file=sys.stderr)


def _skybox(spec: str) -> np.ndarray:
    """The (H, W, 3) float32 environment map `spec` names: 'procedural', a
    Radiance .hdr file, or any image file Pillow reads."""
    from raytracingtest_tpu_torch.io import hdr as hdr_mod

    if spec == "procedural":
        return hdr_mod.make_sky_hdr()
    if spec.lower().endswith(".hdr"):
        return hdr_mod.load_hdr(spec)
    try:
        from PIL import Image
    except ImportError:
        raise SystemExit(f"--skybox {spec}: reading this image needs Pillow, "
                         "which is not installed; use a Radiance .hdr file or "
                         "'procedural'") from None
    return np.asarray(Image.open(spec).convert("RGB"), np.float32) / 255.0


def cmd_render(args):
    from raytracingtest_tpu_torch.config import CameraConfig, RenderConfig
    from raytracingtest_tpu_torch.models import SurfaceRenderer, VolumetricRenderer
    from raytracingtest_tpu_torch.models.renderers import _camera
    from raytracingtest_tpu_torch.utils.profiling import RaysPerSecond

    device = args.device
    host_svo = _load_or_build(args.scene, args.depth, args.cache_dir,
                              getattr(args, "load", ""))
    svo = host_svo.to(device)
    cam = CameraConfig(
        position=tuple(args.camera_position),
        look_at=tuple(args.look_at), fov_y_deg=args.fov,
        width=args.width, height=args.height,
        ortho_height=args.ortho_height)
    rnd = RenderConfig(samples=args.samples, volumetric_k=args.volumetric_k)
    shape = (args.height, args.width, 3)
    if args.skybox and (args.lod_coef > 0.0 or args.attachments
                        or args.volumetric_k > 0
                        or (args.specular > 0.0 and args.bounces > 1)):
        raise SystemExit("--skybox combines only with the surface render; "
                         "drop --lod-coef/--attachments/--volumetric-k/"
                         "--specular")
    if args.skybox:
        # an environment map sampled on a miss
        model = SurfaceRenderer(svo, device=device)
        img = model.render_progressive(cam, rnd, skybox=_skybox(args.skybox))
    elif args.lod_coef > 0.0:
        # the LOD render: the brick route on a tree with bricks, else the
        # stackless one; a ray stopped at a node shades from the node's
        # averaged attributes
        from raytracingtest_tpu_torch.ops import brick as brick_mod
        from raytracingtest_tpu_torch.ops import brick_cuda
        from raytracingtest_tpu_torch.ops import lod as lod_mod
        o, d = _camera(cam).rays(device)
        node_albedo, node_normal = (
            t.to(device) for t in lod_mod.compute_node_attributes(host_svo))
        if svo.depth >= brick_mod.BRICK_LEVELS + 1:
            bsvo = brick_mod.make_brick_svo(host_svo).to(device)
            res = brick_cuda.trace_brick_lod_cuda(bsvo, o, d, args.lod_coef,
                                                  width=cam.width)
            img = lod_mod.shade_lod(svo, node_albedo, node_normal, res, d)
        else:
            img, _ = lod_mod.render_lod(svo, node_albedo, node_normal, o, d,
                                        args.lod_coef, width=cam.width)
        img = img.reshape(shape)
    elif args.attachments:
        # shading from the compressed 64-bit attachment words
        from raytracingtest_tpu_torch import render as render_mod
        from raytracingtest_tpu_torch.ops import codecs
        o, d = _camera(cam).rays(device)
        wa, wb = (w.to(device) for w in codecs.build_attachments(host_svo))
        img = render_mod.render_attachment(svo, wa, wb, o, d).reshape(shape)
    elif args.specular > 0.0 and args.bounces > 1:
        # mirror reflections through the brick trace
        from raytracingtest_tpu_torch.ops import brick as brick_mod
        from raytracingtest_tpu_torch.render import Light, render_bounce
        bsvo = brick_mod.make_brick_svo(host_svo).to(device)
        img = render_bounce(bsvo, svo.leaf_albedo, svo.leaf_normal,
                            _camera(cam), light=Light(),
                            specular=args.specular, bounces=args.bounces,
                            device=device)
    elif args.volumetric_k > 0:
        model = VolumetricRenderer(svo, k=args.volumetric_k, device=device)
        img = model.render(cam, rnd)
    else:
        model = SurfaceRenderer(svo, device=device)
        counter = RaysPerSecond()
        with counter.frame(args.width * args.height * max(args.samples, 1),
                           device):
            img = model.render_progressive(cam, rnd)
        print(counter.summary(), file=sys.stderr)
    _save_png(img, args.out)


def cmd_fit(args):
    """Inverse-rendering fit: recover voxel albedo from posed target
    images, on one device, or with rays sharded over the processes of a
    ``torch.distributed`` world when the environment configures one
    (``parallel/multihost.py``): each process trains on its rows, and
    process 0 writes the checkpoint."""
    from raytracingtest_tpu_torch.parallel import multihost
    from raytracingtest_tpu_torch.parallel.mesh import rank_device
    info = multihost.init_from_env(device=args.device)

    from raytracingtest_tpu_torch import diff
    from raytracingtest_tpu_torch.config import CameraConfig
    from raytracingtest_tpu_torch.io import checkpoint as ckpt
    from raytracingtest_tpu_torch.models import InverseRenderer
    from raytracingtest_tpu_torch.ops.camera import Camera

    device = rank_device(args.device) if info["initialized"] else args.device
    # process 0 builds and caches the tree; the others then load it
    later = info["initialized"] and info["process_index"] != 0
    if later:
        torch.distributed.barrier()
    svo = _load_or_build(args.scene, args.depth, args.cache_dir).to(device)
    if info["initialized"] and not later:
        torch.distributed.barrier()
    light = torch.tensor(_LIGHT, dtype=torch.float32, device=device)
    model = InverseRenderer(svo, optimize=("albedo",),
                            learning_rate=args.lr, device=device)

    # posed views on a circle around the scene
    rng = np.random.default_rng(args.seed)
    views = []
    res = args.view_resolution
    for v in range(args.views):
        ang = 2 * np.pi * v / args.views
        pos = (0.5 + 1.1 * np.cos(ang), 0.6 + 0.25 * rng.random(),
               0.5 + 1.1 * np.sin(ang))
        ccfg = CameraConfig(position=pos, look_at=(0.5, 0.5, 0.5),
                            fov_y_deg=45.0, width=res, height=res)
        cam = Camera(position=pos, look_at=(0.5, 0.5, 0.5), fov_y_deg=45.0,
                     width=res, height=res)
        o, d = cam.rays(device)
        # the per-ray ESVO frame, as the JAX command's diff.render_diff
        with torch.no_grad():
            target = diff.render_diff_cuda(svo.leaf_albedo, svo.leaf_normal,
                                           svo.leaf_density, svo, o, d, light)
        views.append((ccfg, target))
    print(f"synthesized {len(views)} posed target views at {res}x{res}",
          file=sys.stderr)

    params, opt_state = model.init_params(seed=args.seed,
                                          randomize=("albedo",))
    t0 = time.time()
    resid_total = 0
    for step in range(args.steps):
        ccfg, target = views[step % len(views)]
        # the reference's route (tile, else brick, else stackless); residual
        # counts the rays whose loss terms used cap-limited hits
        params, opt_state, loss, resid = model.step_view(
            params, opt_state, ccfg, light, target)
        resid_total += int(resid)
        if step % max(args.steps // 10, 1) == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {float(loss):.3e}  "
                  f"residual {int(resid)}  ({time.time()-t0:.1f}s)",
                  file=sys.stderr)
    if resid_total:
        print(f"WARNING: {resid_total} ray-steps trained on cap-limited "
              "hits (raise fb_tiles/fb_k)", file=sys.stderr)
    err = float((params["albedo"] - svo.leaf_albedo).abs().mean())
    print(f"final mean |albedo error| = {err:.4f}", file=sys.stderr)
    if info["process_index"] != 0:
        return
    os.makedirs(args.out_dir, exist_ok=True)
    ckpt.save_train_state(os.path.join(args.out_dir, "fit_state.npz"),
                          params, opt_state, step=args.steps,
                          meta={"scene": args.scene, "depth": args.depth})
    print(f"saved {args.out_dir}/fit_state.npz", file=sys.stderr)


def _fence(t):
    """Wait for the frame `t` by reading one of its values."""
    t.reshape(-1)[:1].cpu()


def cmd_fly(args):
    """The flythrough of the streamed world: a camera path drives the
    StreamingRenderer, each frame a clipmap update, a span copy to the
    device, the stitched pyramids and one tile frame with progressive
    accumulation. While the camera rests, jittered frames accumulate;
    motion resets the count. --path brick renders each frame with the
    per-ray stitched trace (trace_clipmap_device_brick) instead."""
    from raytracingtest_tpu_torch import diff
    from raytracingtest_tpu_torch.models import StreamingRenderer
    from raytracingtest_tpu_torch.ops.camera import Camera
    from raytracingtest_tpu_torch.scenes import get_scene
    from raytracingtest_tpu_torch.stream.clipmap import trace_clipmap_device_brick

    device = args.device
    sr = StreamingRenderer(
        get_scene(args.scene), min_chunk_size=args.min_chunk,
        radius=args.radius, lods=args.lods, chunk_depth=args.chunk_depth,
        node_capacity=args.arena_nodes, leaf_capacity=args.arena_leaves,
        device=device)
    light = torch.tensor(_LIGHT, dtype=torch.float32, device=device)

    frames = []
    os.makedirs(args.out_dir, exist_ok=True)
    res = args.resolution
    stats_total = {"update_ms": 0.0, "render_ms": 0.0}
    acc, sample, last_pose = None, 0, None
    # a lateral sweep above the terrain looking ahead and down, then
    # hold_frames at the last pose (the camera rests: accumulation)
    total = args.frames + args.hold_frames
    for f in range(total):
        u = min(f, args.frames - 1) / max(args.frames - 1, 1)
        pos = np.array([0.18 + 0.55 * u, 0.72, 0.12 + 0.2 * u])
        look = np.array([0.5 + 0.3 * (u - 0.5), 0.3, 0.6])

        t0 = time.time()
        st = sr.update(pos)
        t_update = time.time() - t0

        cam = Camera(position=tuple(pos), look_at=tuple(look), fov_y_deg=55.0,
                     width=res, height=res)
        t0 = time.time()
        keep = (f % max(total // 8, 1) == 0) or f == total - 1
        if args.path == "tile":
            if keep or args.save_frames:
                px, n_un = sr.render(cam)
            else:
                _acc, un = sr.render(cam, fetch=False)
                n_un = int(un)   # a scalar read: the frame is done
                px = None
            sample = sr.sample_count
        else:
            # the per-ray stitched trace through the brick arena
            pose = (tuple(pos), tuple(look))
            if pose != last_pose:
                acc, sample, last_pose = None, 0, pose
            o, d = cam.rays(device)
            clip, devb = sr.clipmap, sr.device_bricks
            trunk, roots, origins, sizes = clip.master_brick()
            leaf, _t, _chunk, _trunc = trace_clipmap_device_brick(
                trunk, tuple(clip.octree.root.position), clip.octree.root.size,
                roots, origins, sizes, args.chunk_depth, devb, o, d)
            img = diff.shade_diff(leaf, d, sr.device_arena.leaf_albedo,
                                  sr.device_arena.leaf_normal,
                                  sr.device_arena.leaf_density, light, 1.3, 0.08)
            img = img.reshape(res, res, 3)
            acc = img if sample == 0 else acc + (img - acc) / (sample + 1)
            sample += 1
            _fence(acc)
            px, n_un = acc, 0
        t_render = time.time() - t0

        stats_total["update_ms"] += t_update * 1e3
        stats_total["render_ms"] += t_render * 1e3
        print(f"frame {f:3d}  update {t_update*1e3:7.1f} ms "
              f"(+{st['added']}/-{st['evicted']} chunks, "
              f"{st['resident']} resident, "
              f"{st['node_spans']}+{st['brick_spans']} spans)  "
              f"render {t_render*1e3:7.1f} ms  samples {sample}"
              + (f"  residual {n_un}" if n_un else ""),
              file=sys.stderr)
        if px is not None:
            px = px.reshape(res, res, 3).cpu().numpy()
            if keep:
                frames.append(px.copy())
            if args.save_frames:
                _save_png(px, os.path.join(args.out_dir, f"fly_{f:03d}.png"))

    _save_png(np.concatenate(frames, axis=1),
              os.path.join(args.out_dir, "fly_strip.png"))
    print(f"avg/frame: update+sync+master {stats_total['update_ms']/total:.1f} "
          f"ms  render {stats_total['render_ms']/total:.1f} ms",
          file=sys.stderr)


def cmd_info(args):
    svo = _load_or_build(args.scene, args.depth, args.cache_dir,
                         getattr(args, "load", ""))
    src = args.load if getattr(args, "load", "") else args.scene
    print(f"scene={src} depth={svo.depth}")
    print(f"nodes={svo.n_nodes} leaves={svo.n_leaves}")
    for l in range(svo.depth):
        lo, hi = svo.level_start[l], svo.level_start[l + 1]
        print(f"  level {l:2d}: {hi - lo:9d} nodes")
    bytes_total = svo.n_nodes * 12 + svo.n_leaves * (12 + 12 + 4)
    print(f"memory: {bytes_total/1e6:.1f} MB (nodes + fp leaf attributes)")


def cmd_debug(args):
    """Node-box overlay render and/or a textual list of every leaf a probe
    ray passes through."""
    from raytracingtest_tpu_torch import viz
    from raytracingtest_tpu_torch.ops.camera import Camera
    from raytracingtest_tpu_torch.render import render_image

    host_svo = _load_or_build(args.scene, args.depth, args.cache_dir)
    svo = host_svo.to(args.device)
    if args.ray is not None:
        o = args.ray[:3]
        d = args.ray[3:]
        entries = viz.ray_probe(svo, o, d, max_hits=args.max_hits)
        print(viz.format_probe(entries))
    if args.out:
        cam = Camera(position=tuple(args.camera_position),
                     look_at=tuple(args.look_at), fov_y_deg=args.fov,
                     width=args.width, height=args.height)
        img = render_image(svo, cam, device=args.device).cpu().numpy().copy()
        origins, size = viz.node_boxes(host_svo, args.level)
        viz.draw_boxes(img, cam, origins, size,
                       max_boxes=args.max_boxes)
        _save_png(img, args.out)
        print(f"wrote {args.out} ({len(origins)} level-{args.level} boxes)")


def cmd_probe(args):
    """The probe session, headless: a ray whose end points move re-probes
    on each change, cubes insert into and delete from a chunk octree, and
    a changed scene or depth rebuilds the tree and re-probes. Commands come
    from stdin, or ';'-separated from --commands:

      from X Y Z | to X Y Z   move a ray end point (re-probes)
      scene NAME | depth N    rebuild the SVO (re-probes)
      level N                 the node-box level of the overlay
      render [PATH]           render + node boxes + the ray -> PNG
      insert X Y Z S          insert a cube into the chunk octree
      delete X Y Z S          remove it
      boxes                   print the inserted cubes
      probe                   print the current ray's leaf list again
      quit
    """
    from raytracingtest_tpu_torch import viz
    from raytracingtest_tpu_torch.ops.camera import Camera
    from raytracingtest_tpu_torch.render import render_image
    from raytracingtest_tpu_torch.stream.chunk_octree import ChunkOctree

    state = {
        "scene": args.scene, "depth": args.depth, "level": args.level,
        "from": np.asarray([0.1, 0.9, 0.1], np.float64),
        "to": np.asarray([0.9, 0.1, 0.9], np.float64),
        "svo": None, "host_svo": None,
    }
    octree = ChunkOctree(origin=(0.0, 0.0, 0.0), size=1.0)
    boxes = {}

    def rebuild():
        state["host_svo"] = _load_or_build(state["scene"], state["depth"],
                                           args.cache_dir)
        state["svo"] = state["host_svo"].to(args.device)
        print(f"svo: {state['scene']} depth={state['depth']} "
              f"{state['svo'].n_nodes} nodes")

    def probe():
        d = state["to"] - state["from"]
        n = np.linalg.norm(d)
        if n < 1e-12:
            print("(degenerate ray)")
            return
        entries = viz.ray_probe(state["svo"], state["from"], d / n,
                                max_hits=args.max_hits)
        print(f"ray {state['from'].tolist()} -> {state['to'].tolist()}")
        print(viz.format_probe(entries))

    def render(path):
        cam = Camera(position=tuple(args.camera_position),
                     look_at=tuple(args.look_at), fov_y_deg=args.fov,
                     width=args.width, height=args.height)
        img = render_image(state["svo"], cam, device=args.device).cpu().numpy().copy()
        origins, size = viz.node_boxes(state["host_svo"], state["level"])
        viz.draw_boxes(img, cam, origins, size, max_boxes=args.max_boxes)
        for pos, s in boxes.values():
            viz.draw_boxes(img, cam, np.asarray([pos], np.float32), float(s),
                           color=(1.0, 1.0, 0.2))
        viz.draw_segment(img, cam, state["from"], state["to"])
        _save_png(img, path)

    rebuild()
    probe()
    if args.commands:
        lines = [c.strip() for c in args.commands.split(";") if c.strip()]
    else:
        print("probe> reading commands from stdin (see --help)", file=sys.stderr)
        lines = (ln.strip() for ln in sys.stdin)
    for line in lines:
        if not line or line.startswith("#"):
            continue
        cmd, *rest = line.split()
        try:
            if cmd == "quit":
                break
            elif cmd in ("from", "to"):
                state[cmd] = np.asarray([float(v) for v in rest[:3]])
                probe()
            elif cmd == "scene":
                state["scene"] = rest[0]
                rebuild()
                probe()
            elif cmd == "depth":
                state["depth"] = int(rest[0])
                rebuild()
                probe()
            elif cmd == "level":
                state["level"] = int(rest[0])
                print(f"level {state['level']}")
            elif cmd == "render":
                render(rest[0] if rest else (args.out or "probe.png"))
            elif cmd == "insert":
                x, y, z, s = (float(v) for v in rest[:4])
                octree.add_chunk((x, y, z), s, chunk=(x, y, z, s))
                boxes[(x, y, z, s)] = ((x, y, z), s)
                print(f"inserted ({x},{y},{z}) size {s}; {len(boxes)} cubes")
            elif cmd == "delete":
                x, y, z, s = (float(v) for v in rest[:4])
                ok = octree.remove_chunk((x, y, z), s)
                boxes.pop((x, y, z, s), None)
                print("removed" if ok else "not found")
            elif cmd == "boxes":
                for pos, s in boxes.values():
                    print(f"cube at {pos} size {s}")
                print(f"octree root size {octree.root.size}")
            elif cmd == "probe":
                probe()
            else:
                print(f"? unknown command {cmd!r}")
        except (ValueError, IndexError) as e:
            print(f"! {e}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="raytracingtest_tpu_torch")
    p.add_argument("--cache-dir",
                   default=os.path.join(tempfile.gettempdir(), "rtt_cache"))
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: cuda:0, an error "
                   "where there is no card; 'cpu' runs the plain versions)")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene to PNG")
    pr.add_argument("--attachments", action="store_true",
                    help="shade from the compressed 64-bit attachment words "
                    "(R5G6B5 palette + normal16) instead of fp attributes")
    pr.add_argument("--lod-coef", type=float, default=0.0,
                    help="LOD footprint coefficient (>0 enables ray-size "
                    "early exit through the brick path; ~2*tan(fov/2)/H "
                    "matches one pixel)")
    pr.add_argument("--scene", default="terrain")
    pr.add_argument("--depth", type=int, default=8)
    pr.add_argument("--width", type=int, default=512)
    pr.add_argument("--height", type=int, default=512)
    pr.add_argument("--fov", type=float, default=50.0)
    pr.add_argument("--ortho-height", type=float, default=0.0)
    pr.add_argument("--camera-position", type=float, nargs=3,
                    default=[0.5, 0.85, -0.6])
    pr.add_argument("--look-at", type=float, nargs=3, default=[0.5, 0.4, 0.5])
    pr.add_argument("--samples", type=int, default=1)
    pr.add_argument("--bounces", type=int, default=1,
                    help="reflection bounces (with --specular > 0)")
    pr.add_argument("--specular", type=float, default=0.0,
                    help="mirror reflectance per bounce (ref ships 0)")
    pr.add_argument("--volumetric-k", type=int, default=0)
    pr.add_argument("--skybox", default="",
                    help="environment map sampled on miss: a Radiance .hdr "
                    "file, any image file (through Pillow), or 'procedural' "
                    "(baked daytime map with an HDR sun disc)")
    pr.add_argument("--load", default="",
                    help="render a saved SVO checkpoint (.npz) instead of "
                    "building --scene/--depth")
    pr.add_argument("--out", default="render.png")
    pr.set_defaults(fn=cmd_render)

    pf = sub.add_parser("fit", help="inverse-rendering fit of voxel albedo")
    pf.add_argument("--scene", default="sphere")
    pf.add_argument("--depth", type=int, default=6)
    pf.add_argument("--views", type=int, default=32)
    pf.add_argument("--view-resolution", type=int, default=128)
    pf.add_argument("--steps", type=int, default=200)
    pf.add_argument("--lr", type=float, default=5e-2)
    pf.add_argument("--seed", type=int, default=0)
    pf.add_argument("--out-dir",
                    default=os.path.join(tempfile.gettempdir(), "rtt_fit"))
    pf.set_defaults(fn=cmd_fit)

    pfly = sub.add_parser("fly", help="flythrough: streaming clipmap world "
                          "rendered per frame (Main scene)")
    pfly.add_argument("--scene", default="terrain")
    pfly.add_argument("--frames", type=int, default=16)
    pfly.add_argument("--resolution", type=int, default=256)
    pfly.add_argument("--min-chunk", type=float, default=0.25)
    pfly.add_argument("--radius", type=int, default=2)
    pfly.add_argument("--lods", type=int, default=2)
    pfly.add_argument("--chunk-depth", type=int, default=5)
    pfly.add_argument("--arena-nodes", type=int, default=2_000_000)
    pfly.add_argument("--arena-leaves", type=int, default=4_000_000)
    pfly.add_argument("--save-frames", action="store_true")
    pfly.add_argument("--out-dir",
                      default=os.path.join(tempfile.gettempdir(), "rtt_fly"))
    pfly.add_argument("--path", choices=["tile", "brick"], default="tile",
                      help="tile = the stitched pyramids through the tile "
                      "trace (default); brick = the per-ray two-phase "
                      "stitched trace")
    pfly.add_argument("--hold-frames", type=int, default=4,
                      help="extra frames at the last pose: the camera rests, "
                      "so jittered samples accumulate")
    pfly.set_defaults(fn=cmd_fly)

    pi = sub.add_parser("info", help="print SVO statistics")
    pi.add_argument("--load", default="",
                    help="inspect a saved SVO checkpoint (.npz)")
    pi.add_argument("--scene", default="terrain")
    pi.add_argument("--depth", type=int, default=8)
    pi.set_defaults(fn=cmd_info)

    pd = sub.add_parser("debug",
                        help="node-box overlay + ray probe (SVODriver)")
    pd.add_argument("--scene", default="sphere")
    pd.add_argument("--depth", type=int, default=5)
    pd.add_argument("--level", type=int, default=3)
    pd.add_argument("--ray", type=float, nargs=6, default=None,
                    metavar=("OX", "OY", "OZ", "DX", "DY", "DZ"))
    pd.add_argument("--max-hits", type=int, default=32)
    pd.add_argument("--max-boxes", type=int, default=4096)
    pd.add_argument("--width", type=int, default=512)
    pd.add_argument("--height", type=int, default=512)
    pd.add_argument("--fov", type=float, default=50.0)
    pd.add_argument("--camera-position", type=float, nargs=3,
                    default=[0.5, 0.85, -0.6])
    pd.add_argument("--look-at", type=float, nargs=3, default=[0.5, 0.4, 0.5])
    pd.add_argument("--out", default="")
    pd.set_defaults(fn=cmd_debug)

    pp = sub.add_parser("probe", help="interactive probe session (draggable "
                        "ray + live chunk-octree insert/delete, headless)")
    pp.add_argument("--scene", default="sphere")
    pp.add_argument("--depth", type=int, default=5)
    pp.add_argument("--level", type=int, default=3)
    pp.add_argument("--max-hits", type=int, default=32)
    pp.add_argument("--max-boxes", type=int, default=4096)
    pp.add_argument("--width", type=int, default=512)
    pp.add_argument("--height", type=int, default=512)
    pp.add_argument("--fov", type=float, default=50.0)
    pp.add_argument("--camera-position", type=float, nargs=3,
                    default=[0.5, 0.85, -0.6])
    pp.add_argument("--look-at", type=float, nargs=3, default=[0.5, 0.4, 0.5])
    pp.add_argument("--out", default="")
    pp.add_argument("--commands", default="",
                    help="';'-separated commands (scripted mode); omit to "
                    "read stdin")
    pp.set_defaults(fn=cmd_probe)

    args = p.parse_args(argv)
    try:
        args.device = resolve(args.device)
    except RuntimeError as e:
        raise SystemExit(f"{p.prog}: {e}") from None
    args.fn(args)


if __name__ == "__main__":
    main()
