"""One run of one cell: set-up, the measured window, the traced stretch, the
check against the reference, and the result line.

The system under test is the port, ``raytracingtest_tpu_torch``, driven
through the entry points its users call: ``InverseRenderer.step`` for a fit
mix, and the configuration's renderer's ``render`` (``SurfaceRenderer`` or
``VolumetricRenderer``) for a serving mix. The benchmark hands it inputs
made from the seed and reads back only what those calls return, and, to
judge them, the tree and brick form its set-up built. The reference
(``refbuild``, ``refwalk``, ``refshade``) runs once the window has closed
and the program's state is freed.
"""

from __future__ import annotations

import gc
import hashlib
import math
import os
import sys
import time

import numpy as np
import torch

from rtb import refbuild, refshade, refwalk, spec, trace, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "raytracingtest_tpu")
# the benchmark's own cache (the reference's tree), inside the checkout
CACHE = os.path.join(spec.ROOT, "build", "rtbench")
ALTER = 2.0 ** -6     # the altered answer's offset (the `alter` fault)
STRUCTURE = ("masks", "child_base", "leaf_base", "parent_ptr")
BRICK_TABLES = ("top_masks", "top_child", "top_parent", "bricks")
ATTRS = (("albedo", "leaf_albedo"), ("normal", "leaf_normal"),
         ("density", "leaf_density"))


def say(*parts):
    print(*parts, file=sys.stderr, flush=True)


def process_start_time():
    """The wall-clock time this process started, from /proc; the import
    time of this module where /proc has none."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def forbidden_modules():
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's (names compared whole)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """What a metric's reader reads: the window, the set-up, the traced
    stretch and the work each traced call needed."""

    def __init__(self):
        self.setup_s = None
        self.window_s = None
        self.calls = 0
        self.rays = 0
        self.call_host_s = []      # call to return, each window call
        self.frame_s = []          # call to the frame's end on the device
        self.synced_host_s = []    # call to return, calls made on an idle card
        self.stretch = None        # trace.Stretch
        self.stretch_calls = 0
        self.work = []             # work of each traced call, in order


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_host(t):
    return t.detach().cpu().numpy()


def _words_off(a, b):
    """Entries of two integer arrays that differ, every entry where the
    shapes differ."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return int(max(a.size, b.size))
    return int(np.count_nonzero(a != b))


def _gap(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return math.inf
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def _tree_checks(prog, ref, ref_b, dtype):
    """The set-up's tree and brick form (`prog`, ``_program_tree``) against
    the reference's: words off and the attributes' widest gap. In the
    control the reference's, its attributes rounded to `dtype`, stand in
    the program's place."""
    if dtype is not torch.float32:
        prog = {**ref, **ref_b}
        for name, _ in ATTRS:
            prog[name] = torch.from_numpy(ref[name]).to(dtype).float().numpy()
    return dict(
        svo_words_off=sum(_words_off(prog[k], ref[k]) for k in STRUCTURE),
        brick_words_off=sum(_words_off(prog[k], ref_b[k]) for k in BRICK_TABLES),
        attr_gap=max(_gap(prog[name], ref[name]) for name, _ in ATTRS))


def _program_tree(svo, bsvo):
    out = {k: _to_host(getattr(svo, k)) for k in STRUCTURE}
    out.update({name: _to_host(getattr(svo, field)) for name, field in ATTRS})
    out.update({k: _to_host(getattr(bsvo, k)) for k in BRICK_TABLES})
    return out


def _reference_tree(cfg, device):
    """The reference's tree and brick form of the configuration, built once
    a checkout and kept under ``build/rtbench/`` (keyed by the scene, the
    depth and ``refbuild``'s source); later runs load them."""
    key = hashlib.sha256(repr((cfg["scene"], cfg["depth"])).encode())
    with open(refbuild.__file__, "rb") as f:
        key.update(f.read())
    path = os.path.join(CACHE, f"reference-{cfg['scene']}-{cfg['depth']}-"
                               f"{key.hexdigest()[:16]}.npz")
    t0 = time.perf_counter()
    if os.path.exists(path):
        with np.load(path) as z:
            ref = {k[4:]: z[k] for k in z.files if k.startswith("svo.")}
            ref_b = {k[6:]: z[k] for k in z.files if k.startswith("brick.")}
        for d in (ref, ref_b):
            for k in ("depth", "top_depth"):
                if k in d:
                    d[k] = int(d[k])
        how = "loaded"
    else:
        scene = refbuild.device_scene(cfg["scene"], device)
        ref = refbuild.build_svo(scene, refbuild.LIPSCHITZ[cfg["scene"]], cfg["depth"])
        ref_b = refbuild.make_brick_svo(ref)
        os.makedirs(CACHE, exist_ok=True)
        tmp = path + ".part"
        with open(tmp, "wb") as f:
            np.savez(f, **{"svo." + k: v for k, v in ref.items()},
                     **{"brick." + k: v for k, v in ref_b.items()})
        os.replace(tmp, path)
        how = "built"
    say(f"reference tree {how}: {ref['masks'].size} nodes, {ref['albedo'].shape[0]} "
        f"leaves, {ref_b['bricks'].shape[0]} bricks, {time.perf_counter() - t0:.2f} s")
    return ref, ref_b


def _table_bytes(ref_b):
    return sum(ref_b[k].nbytes for k in BRICK_TABLES)


def _light(cfg):
    lt = cfg["light"]
    return tuple(lt["direction"]), lt["intensity"], lt["ambient"]


class FitDriver:
    """``InverseRenderer.step`` on a fit mix's steps."""

    def __init__(self, cell, seed, device, fault):
        self.seed, self.device, self.fault = seed, device, fault
        self.cfg, self.trf = cell.config, cell.traffic
        self.k = self.trf["check_steps"]

    def setup(self, svo):
        from raytracingtest_tpu_torch.models import InverseRenderer

        cfg = self.cfg
        t0 = time.time()
        self.model = InverseRenderer(svo, optimize=tuple(cfg["optimize"]),
                                     learning_rate=cfg["learning_rate"],
                                     device=self.device)
        _sync(self.device)
        say(f"set-up: InverseRenderer {time.time() - t0:.2f} s")
        if self.fault == "unchanged":
            self.model._update = lambda *args: None
        t0 = time.time()
        self.traffic = traffic.make(self.trf, self.seed, self.device)
        _sync(self.device)
        t1 = time.time()
        self.light = torch.tensor(cfg["light"]["direction"], dtype=torch.float32,
                                  device=self.device)
        self.params, self.opt = self.model.init_params(seed=0, randomize=())
        with torch.no_grad():
            self.params["albedo"].copy_(self.traffic.init_albedo(svo.n_leaves))
        p0 = self.params["albedo"].clone()
        _sync(self.device)
        say(f"set-up: the mix's inputs {t1 - t0:.2f} s, the parameters and Adam "
            f"{time.time() - t1:.2f} s")
        # the first steps, through the window's own call and feed: their
        # losses, the first gradient as Adam holds it, and the change of
        # the parameters after them
        self.losses = []
        self.g1_norm = torch.zeros((), dtype=torch.float64, device=self.device)
        for s in range(self.k):
            t0 = time.time()
            self.losses.append(self.call(s))
            _sync(self.device)
            say(f"set-up: step {s} {time.time() - t0:.2f} s")
            if s == 0:
                state = self.opt.state.get(self.params["albedo"], {})
                if "exp_avg" in state:
                    self.g1_norm = (state["exp_avg"].double()
                                    / (1.0 - refshade.BETAS[0])).norm()
        self.delta_norm = (self.params["albedo"].double() - p0.double()).norm()
        del p0

    def call(self, i):
        o, d, target = self.traffic.batch(i)
        if self.fault == "half_batch":
            half = o.shape[0] // 2
            o, d, target = o[:half], d[:half], target[:half]
        self.params, self.opt, loss = self.model.step(
            self.params, self.opt, o, d, self.light, target)
        return loss

    def window(self, run, seconds):
        i = self.k
        clock = time.perf_counter
        t0 = clock()
        while True:
            a = clock()
            self.call(i)
            run.call_host_s.append(clock() - a)
            i += 1
            if clock() - t0 >= seconds:
                break
        _sync(self.device)
        run.window_s = clock() - t0
        run.calls = i - self.k
        run.rays = run.calls * self.traffic.rays_per_step

    def replay(self, j):
        """A traced call: step j's batch again, cycling over the first
        steps, whose work the reference counts."""
        self.call(j % self.k)

    def synced(self, run, n):
        for j in range(n):
            a = time.perf_counter()
            self.call(j % self.k)
            run.synced_host_s.append(time.perf_counter() - a)
            _sync(self.device)

    def outputs(self):
        from raytracingtest_tpu_torch.models import renderers

        bsvo = renderers._accel_of(self.model)[0]
        out = _program_tree(self.model.svo, bsvo)
        out["losses"] = [float(x) for x in self.losses]
        out["g1_norm"] = float(self.g1_norm)
        out["delta_norm"] = float(self.delta_norm)
        return out

    def free(self):
        for name in ("model", "params", "opt", "losses", "g1_norm", "delta_norm"):
            setattr(self, name, None)

    def judge(self, prog, dtype):
        """The checks' numbers and the work of each step the reference
        followed."""
        cfg, device = self.cfg, self.device
        ref, ref_b = _reference_tree(cfg, device)
        checks = _tree_checks(prog, ref, ref_b, dtype)
        bricks = refbuild.bricks_on(ref_b, device)
        normal = torch.from_numpy(ref["normal"]).to(device)
        density = torch.from_numpy(ref["density"]).to(device)
        light = _light(cfg)
        # the first steps' rays walked together, once
        t0 = time.perf_counter()
        batches = [self.traffic.batch(s) for s in range(self.k)]
        n = batches[0][0].shape[0]
        res = refwalk.trace_brick(bricks, torch.cat([b[0] for b in batches]),
                                  torch.cat([b[1] for b in batches]))
        say(f"reference walk: {self.k} steps of {n} rays, {time.perf_counter() - t0:.2f} s")
        work = []
        for s in range(self.k):
            sl = slice(s * n, (s + 1) * n)
            leaf = res["hit_leaf"][sl]
            hit = leaf[leaf >= 0]
            dda = int(res["dda_steps"][sl].sum())
            work.append(dict(
                rays=n, top_steps=int(res["iters"][sl].sum()) - dda, dda_steps=dda,
                hits=int(hit.numel()), touched=int(torch.unique(hit).numel()),
                leaves=ref["albedo"].shape[0], table_bytes=_table_bytes(ref_b)))
        seen = {}
        for tag, dt in (("ref", torch.float32), ("ctl", dtype)):
            if tag == "ctl" and dtype is torch.float32:
                break
            p0 = self.traffic.init_albedo(ref["albedo"].shape[0])
            adam = refshade.Adam(p0, cfg["learning_rate"])
            losses, g1 = [], None
            for s, (_o, d, target) in enumerate(batches):
                leaf = res["hit_leaf"][s * n:(s + 1) * n]
                loss, grad = refshade.l2_step(leaf, d, target, adam.param, normal,
                                              density, light, dt)
                losses.append(float(loss))
                if s == 0:
                    g1 = float(grad.norm())
                adam.step(grad)
                del grad
            seen[tag] = (losses, g1, float((adam.param.double() - p0.double()).norm()))
        del res, batches
        r_losses, r_g1, r_delta = seen["ref"]
        p_losses, p_g1, p_delta = seen["ctl"] if "ctl" in seen else (
            prog["losses"], prog["g1_norm"], prog["delta_norm"])
        checks["loss_gap"] = max(abs(a - b) / abs(b) for a, b in zip(p_losses, r_losses))
        checks["grad_norm_gap"] = abs(p_g1 - r_g1) / r_g1
        checks["update_norm_gap"] = abs(p_delta - r_delta) / r_delta
        say(f"losses: program {p_losses}, reference {r_losses}; first gradient's "
            f"norm {p_g1!r} against {r_g1!r}; change's norm {p_delta!r} against {r_delta!r}")
        return checks, work


class ServeDriver:
    """The configuration's renderer's ``render`` on a serving mix's
    frames, each waited for before the next is asked for."""

    def __init__(self, cell, seed, device, fault):
        self.seed, self.device, self.fault = seed, device, fault
        self.cfg, self.trf = cell.config, cell.traffic

    def setup(self, svo):
        from raytracingtest_tpu_torch.config import CameraConfig, RenderConfig
        from raytracingtest_tpu_torch.models import SurfaceRenderer, VolumetricRenderer

        cfg = self.cfg
        if cfg["renderer"] == "volumetric":
            self.model = VolumetricRenderer(svo, k=cfg["k"],
                                            density_scale=cfg["density_scale"],
                                            device=self.device)
        else:
            self.model = SurfaceRenderer(svo, device=self.device)
        self.traffic = traffic.make(self.trf, self.seed, self.device)
        direction, intensity, ambient = _light(cfg)
        self.render_cfg = RenderConfig(light_direction=direction,
                                       light_intensity=intensity,
                                       light_ambient=ambient)
        self._camera = CameraConfig
        self.keep = set(self.traffic.check_frames)
        self.kept, self.last = {}, None
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
        # the shapes this mix uses, and the model's tables, before the window
        for i in (-2, -1):
            self.call(i)
        _sync(self.device)

    def camera(self, i):
        p = self.traffic.pose(i)
        return self._camera(position=p["position"], look_at=p["look_at"], up=p["up"],
                            fov_y_deg=p["fov_y_deg"], width=self.traffic.width,
                            height=self.traffic.height)

    def call(self, i):
        img = self.model.render(self.camera(i), self.render_cfg)
        if self.fault == "alter":
            img[..., 0] += ALTER
        return img

    def window(self, run, seconds):
        clock = time.perf_counter
        i = 0
        t0 = clock()
        while True:
            a = clock()
            if self.cuda:
                self.events[0].record()
            img = self.call(i)
            b = clock()
            if self.cuda:
                self.events[1].record()
            _sync(self.device)
            c = clock()
            run.call_host_s.append(b - a)
            run.frame_s.append(self.events[0].elapsed_time(self.events[1]) * 1e-3
                               if self.cuda else c - a)
            if i in self.keep:
                self.kept[i] = img
            self.last = (i, img)
            i += 1
            if c - t0 >= seconds:
                break
        run.window_s = clock() - t0
        run.calls = i
        run.rays = i * self.traffic.rays_per_frame
        self.kept[self.last[0]] = self.last[1]
        self.last = None

    def replay(self, j):
        frames = sorted(self.kept)
        self.call(frames[j % len(frames)])
        _sync(self.device)

    def synced(self, run, n):
        pass

    def outputs(self):
        from raytracingtest_tpu_torch.models import renderers

        bsvo = renderers._accel_of(self.model)[0]
        out = _program_tree(self.model.svo, bsvo)
        n = self.trf["check_pixels"]
        out["frames"] = {}
        for f, img in sorted(self.kept.items()):
            idx = self.traffic.pixels(f, n)
            out["frames"][f] = img.reshape(-1, 3)[idx].float().cpu()
        return out

    def free(self):
        self.model = self.kept = self.last = None

    def judge(self, prog, dtype):
        cfg, device = self.cfg, self.device
        ref, ref_b = _reference_tree(cfg, device)
        checks = _tree_checks(prog, ref, ref_b, dtype)
        bricks = refbuild.bricks_on(ref_b, device)
        albedo, normal, density = (torch.from_numpy(ref[k]).to(device)
                                   for k in ("albedo", "normal", "density"))
        light = _light(cfg)
        n = self.trf["check_pixels"]
        frames = sorted(prog["frames"])
        t0 = time.perf_counter()
        rays = [self.traffic.rays(f) for f in frames]
        idx = [self.traffic.pixels(f, n) for f in frames]
        o = torch.cat([r[0][i] for r, i in zip(rays, idx)])
        d = torch.cat([r[1][i] for r, i in zip(rays, idx)])
        del rays
        if cfg["renderer"] == "volumetric":
            res = refwalk.trace_brick_multi(bricks, o, d, cfg["k"])
            shade = lambda dt: refshade.volumetric_pixels(
                res, d, albedo, normal, density, light, cfg["density_scale"], dt)
        else:
            res = refwalk.trace_brick(bricks, o, d)
            shade = lambda dt: refshade.surface_pixels(
                res["hit_leaf"], d, albedo, normal, density, light, dt)
        ref_px = shade(torch.float32).cpu()
        prog_px = (torch.cat([prog["frames"][f] for f in frames])
                   if dtype is torch.float32 else shade(dtype).cpu())
        diff = (prog_px - ref_px).abs()
        checks["pixel_gap"] = float(diff.max())
        say(f"reference: {len(frames)} frames {frames}, {n} pixels each, "
            f"{time.perf_counter() - t0:.2f} s")
        # each traced frame's work: its sample's steps, scaled to the frame
        scale = self.traffic.rays_per_frame / n
        work = []
        for j in range(len(frames)):
            sl = slice(j * n, (j + 1) * n)
            dda = float(res["dda_steps"][sl].sum())
            work.append(dict(rays=self.traffic.rays_per_frame, k=cfg.get("k", 1),
                             top_steps=(float(res["iters"][sl].sum()) - dda) * scale,
                             dda_steps=dda * scale, table_bytes=_table_bytes(ref_b)))
        return checks, work


DRIVERS = {"fit": FitDriver, "serve": ServeDriver}


def run(cell, seed, seconds, trace_on, check_mode="program", fault="none",
        device="cuda:0", started=None):
    """One run of `cell` (a ``spec.Cell``); returns the result line's dict,
    or raises. `check_mode` "control" judges the reference computed in
    bfloat16 in the program's place; `fault` breaks the timed path."""
    started = process_start_time() if started is None else started
    device = torch.device(device)
    cfg, trf = cell.config, cell.traffic
    from raytracingtest_tpu_torch import get_scene
    from raytracingtest_tpu_torch.ops.octree_device import build_svo_device

    drv = DRIVERS[trf["mode"]](cell, seed, device, fault)
    t0 = time.time()
    svo = build_svo_device(get_scene(cfg["scene"]), cfg["depth"], device=device)
    _sync(device)
    t1 = time.time()
    drv.setup(svo)
    del svo
    _sync(device)
    say(f"set-up: imports and start {t0 - started:.2f} s, the device build "
        f"{t1 - t0:.2f} s, the model, inputs and warm-up {time.time() - t1:.2f} s")
    r = Run()
    r.setup_s = time.time() - started
    drv.window(r, seconds)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: {found}")
    if trace_on:
        drv.synced(r, trf.get("synced_calls", 0))
        n_warm, n_active = trf["trace_warm"], trf["trace_calls"]
        for attempt in range(3):
            r.stretch = trace.record(drv.replay, n_warm, n_active,
                                     lambda: _sync(device))
            say(f"traced stretch {attempt}: {n_active} calls, {r.stretch.launches} "
                f"launches, {r.stretch.lost} lost, window {r.stretch.window_s!r} s, "
                f"busy {r.stretch.busy_s!r} s")
            if r.stretch.complete:
                break
        r.stretch_calls = n_active
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
    prog = drv.outputs()
    drv.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    dtype = torch.bfloat16 if check_mode == "control" else torch.float32
    checks, work = drv.judge(prog, dtype)
    if trace_on:
        offset = trf["trace_warm"]
        r.work = [work[(offset + j) % len(work)] for j in range(r.stretch_calls)]
    limits = cell.limits
    correct = all(checks[k] <= limits[k] for k in limits) and set(checks) == set(limits)
    metrics = {}
    for m in (cell.per_layer if trace_on else cell.end_to_end):
        value = spec.reader(m["name"])(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                    else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": r.calls, "failed": 0,
           "metrics": metrics, "device": dev}
    if trace_on:
        dev["busy_s"] = r.stretch.busy_s
        dev["window_s"] = r.stretch.window_s
        out["breakdown"] = {"device_ops": r.stretch.device_ops,
                            "idle_gaps": r.stretch.idle_gaps}
    say(f"window: {r.calls} calls, {r.rays} rays in {r.window_s!r} s; set-up "
        f"{r.setup_s!r} s; {len(r.frame_s)} frame times")
    out["checks"] = {k: {"value": checks[k], "limit": limits.get(k)} for k in checks}
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: {found}")
    return out
