"""Model-level API of the port: so far the trainable ``InverseRenderer``."""

from raytracingtest_tpu_torch.models.renderers import InverseRenderer

__all__ = ["InverseRenderer"]
