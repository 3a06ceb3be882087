"""Configuration dataclasses and their file/flag loading (a copy of
``raytracingtest_tpu/config.py``, which imports nothing of JAX itself but
lives in a package that does).

The scene, camera, render and streaming knobs are explicit frozen
dataclasses. A caller rebuilds whatever a changed config invalidates: scene
or depth means a new SVO, camera or light only a new frame.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    scene: str = "terrain"     # reference default sampler "Custom1"
    depth: int = 8             # reference maxLevel (Main.unity:416 ships 5)

    def key(self):
        return (self.scene, self.depth)


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    position: Tuple[float, float, float] = (0.5, 0.85, -0.6)
    look_at: Tuple[float, float, float] = (0.5, 0.4, 0.5)
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    fov_y_deg: float = 50.0
    ortho_height: float = 0.0
    width: int = 512
    height: int = 512


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    samples: int = 1           # progressive accumulation count
    volumetric_k: int = 0      # 0 = hard surface; >0 = k-segment volumetric
    light_direction: Tuple[float, float, float] = (-0.5, -1.0, -0.3)
    light_intensity: float = 1.3
    light_ambient: float = 0.08


@dataclasses.dataclass(frozen=True)
class FitConfig:
    n_views: int = 32          # BASELINE config 4: 32 posed target images
    view_resolution: int = 128
    steps: int = 200
    learning_rate: float = 5e-2
    optimize: Tuple[str, ...] = ("albedo",)
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    n_devices: Optional[int] = None  # None = all


@dataclasses.dataclass(frozen=True)
class Config:
    scene: SceneConfig = SceneConfig()
    camera: CameraConfig = CameraConfig()
    render: RenderConfig = RenderConfig()
    fit: FitConfig = FitConfig()
    mesh: MeshConfig = MeshConfig()

    @staticmethod
    def from_json(path: str) -> "Config":
        with open(path) as f:
            raw = json.load(f)
        return Config(
            scene=SceneConfig(**raw.get("scene", {})),
            camera=CameraConfig(
                **{k: tuple(v) if isinstance(v, list) else v
                   for k, v in raw.get("camera", {}).items()}),
            render=RenderConfig(
                **{k: tuple(v) if isinstance(v, list) else v
                   for k, v in raw.get("render", {}).items()}),
            fit=FitConfig(
                **{k: tuple(v) if isinstance(v, list) else v
                   for k, v in raw.get("fit", {}).items()}),
            mesh=MeshConfig(**raw.get("mesh", {})),
        )

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)
