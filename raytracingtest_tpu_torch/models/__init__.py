"""Model-level API of the port: ``SurfaceRenderer``, ``VolumetricRenderer``
and the trainable ``InverseRenderer``."""

from raytracingtest_tpu_torch.models.renderers import (
    InverseRenderer, SurfaceRenderer, VolumetricRenderer)

__all__ = ["InverseRenderer", "SurfaceRenderer", "VolumetricRenderer"]
