"""raytracingtest_tpu_torch: the sparse-voxel-octree renderer in PyTorch,
with hand-written CUDA kernels for Hopper (sm_90a).

The port of ``raytracingtest_tpu`` (JAX on a TPU), which stays beside it as
the reference. Importing this package builds nothing and touches no CUDA
device: native libraries are built on their first call (``_build``).

Entry points that make tensors take ``device=None``, which means
``default_device()``: the card, or an error where there is none. The CPU is
used only when the caller passes ``device="cpu"``.
"""

from raytracingtest_tpu_torch._device import default_device
from raytracingtest_tpu_torch.ops.camera import Camera
from raytracingtest_tpu_torch.ops.octree import SVO, BuildResult, build_svo
from raytracingtest_tpu_torch.scenes import get_scene

__all__ = ["SVO", "BuildResult", "build_svo", "get_scene", "Camera", "default_device"]
