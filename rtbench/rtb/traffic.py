"""The one generator of every traffic mix: a mix is a JSON file of
parameters under ``rtbench/traffic/``, and this module makes its inputs on
the device from ``--seed``.

Two modes:

  * ``fit``: train steps of ``rays_per_step`` rays against random targets,
    the rays taken from ``views`` posed pinhole views on an orbit (each view
    jittered by a sub-pixel offset drawn from the seed). ``rays: "views"``
    concatenates whole views a step in pixel order (views 0-3, 4-7, ...,
    the same groups for every seed), cycling through the groups from a start
    drawn from the seed; ``rays: "random"`` draws each step's rays
    uniformly, with replacement, from all the views' pixels, a new draw a
    step made on the device.
  * ``serve``: frames of ``width`` x ``height`` pixels, one pose a frame,
    walking the orbit's ``poses`` fixed poses from a start drawn from the
    seed.

Every seed gets the same poses and the same groups of views, so the work a
run does hardly moves with the seed (groups of other views took other times
on the card, PERF.md); the seed moves where the cycle starts, the jitter,
the targets, the initial parameters and the random draws. Step i's and
frame i's inputs are functions of (seed, i), so a step or frame can be made
again.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rtb import camera

UP = (0.0, 1.0, 0.0)


def sub_seed(seed: int, *parts: int) -> int:
    """A seed for one stream of `seed`'s inputs, below 2**63."""
    h = int(seed) % (1 << 63)
    for p in parts:
        h = (h * 1000003 + int(p) + 1) % (1 << 63)
    return h


def orbit_pose(orbit, angle, height):
    c = orbit["center"]
    return dict(position=(c[0] + orbit["radius"] * math.cos(angle), height,
                          c[2] + orbit["radius"] * math.sin(angle)),
                look_at=tuple(c), up=UP, fov_y_deg=orbit["fov_y_deg"])


def view_poses(orbit, n):
    """`n` views evenly spaced in angle, their heights stratified over the
    orbit's range in a fixed order."""
    lo, hi = orbit["height_min"], orbit["height_max"]
    return [orbit_pose(orbit, 2 * math.pi * v / n,
                       lo + (hi - lo) * (((v * 13) % n) + 0.5) / n)
            for v in range(n)]


def frame_poses(orbit, n):
    """`n` poses around the orbit, the height rising and falling twice a
    turn."""
    lo, hi = orbit["height_min"], orbit["height_max"]
    return [orbit_pose(orbit, 2 * math.pi * p / n,
                       lo + (hi - lo) * (0.5 + 0.5 * math.sin(4 * math.pi * p / n)))
            for p in range(n)]


class Fit:
    """A fit mix's steps: ``batch(i)`` is step i's (origins, directions,
    targets), each (rays_per_step, 3) float32 on the device."""

    def __init__(self, params, seed, device):
        self.params, self.seed, self.device = params, seed, torch.device(device)
        w, h, n = params["width"], params["height"], params["views"]
        self.rays_per_step = params["rays_per_step"]
        rng = np.random.default_rng(sub_seed(seed, 1))
        jitter = rng.random((n, 2), dtype=np.float32)
        poses = view_poses(params["orbit"], n)
        per_view = w * h
        self.o = torch.empty((n * per_view, 3), dtype=torch.float32, device=self.device)
        self.d = torch.empty_like(self.o)
        for v in range(n):
            o, d = camera.rays(poses[v], w, h, self.device, jitter=jitter[v])
            self.o[v * per_view:(v + 1) * per_view] = o
            self.d[v * per_view:(v + 1) * per_view] = d
        g = torch.Generator(device=self.device).manual_seed(sub_seed(seed, 2))
        self.target = torch.rand((n * per_view, 3), generator=g, device=self.device)
        self.n_groups = n * per_view // self.rays_per_step
        self.start = int(rng.integers(self.n_groups))

    def init_albedo(self, n_leaves):
        """The trained albedo's first values, uniform in [0, 1)."""
        g = torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, 3))
        return torch.rand((n_leaves, 3), generator=g, device=self.device)

    def rows(self, i):
        """Step i's row indices into the views' pixels, or a slice."""
        n = self.rays_per_step
        if self.params["rays"] == "random":
            g = torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, 4, i))
            return torch.randint(0, self.o.shape[0], (n,), generator=g,
                                 device=self.device)
        a = ((self.start + i) % self.n_groups) * n
        return slice(a, a + n)

    def batch(self, i):
        r = self.rows(i)
        return self.o[r], self.d[r], self.target[r]


class Serve:
    """A serving mix's frames: ``pose(i)`` is frame i's pinhole pose."""

    def __init__(self, params, seed, device):
        self.params, self.seed, self.device = params, seed, torch.device(device)
        self.width, self.height = params["width"], params["height"]
        self.poses = frame_poses(params["orbit"], params["poses"])
        rng = np.random.default_rng(sub_seed(seed, 1))
        self.start = int(rng.integers(len(self.poses)))
        self.direction = 1 if rng.random() < 0.5 else -1
        # the frames kept for the check: drawn from the seed over the span
        # a window reaches, and the last frame of the window besides
        lo, hi = params["check_span"]
        self.check_frames = sorted(int(f) for f in rng.choice(
            np.arange(lo, hi), params["check_frames"], replace=False))
        self.sample_seed = sub_seed(seed, 5)

    @property
    def rays_per_frame(self):
        return self.width * self.height

    def pose(self, i):
        return self.poses[(self.start + self.direction * i) % len(self.poses)]

    def rays(self, i):
        return camera.rays(self.pose(i), self.width, self.height, self.device)

    def pixels(self, i, n):
        """A seeded sample of `n` pixel indices of frame i, without
        replacement."""
        g = torch.Generator(device=self.device).manual_seed(sub_seed(self.sample_seed, i))
        return torch.randperm(self.rays_per_frame, generator=g,
                              device=self.device)[:n]


def make(params, seed, device):
    return {"fit": Fit, "serve": Serve}[params["mode"]](params, seed, device)
