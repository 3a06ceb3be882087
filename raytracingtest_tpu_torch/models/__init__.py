"""Model-level API of the port: ``SurfaceRenderer``, ``VolumetricRenderer``,
the trainable ``InverseRenderer`` and the streamed world's
``StreamingRenderer``."""

from raytracingtest_tpu_torch.models.renderers import (
    InverseRenderer, SurfaceRenderer, VolumetricRenderer)
from raytracingtest_tpu_torch.models.streaming import StreamingRenderer

__all__ = ["InverseRenderer", "StreamingRenderer", "SurfaceRenderer",
           "VolumetricRenderer"]
