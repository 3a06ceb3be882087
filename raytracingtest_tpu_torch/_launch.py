"""The one path from a wrapper to a kernel of the port's CUDA libraries.

A ``Kernel`` is made once for each C entry point, when its wrapper's module
is imported; that builds nothing. Its first launch asks ``_build`` for the
library (which compiles it if need be) and binds the entry point in the
launcher (``csrc/launch.cpp``, also built on first use): the ctypes
function gives its address and, by its ``argtypes``, the kind of each
argument; the calls then go through the launcher, not ctypes. A wrapper
then does three things:

    kernel.check(device, ((name, tensor, dtype, shape), ...))
    out = torch.empty(...)
    kernel(device, pointer and scalar arguments...)

``check`` is the one pass over what guards a pointer: the device is a CUDA
device, and every tensor lies on it with the dtype and shape the kernel
reads and is contiguous. It needs no library and no card, and raises
``ValueError`` with the argument's name. The call appends the raw handle of
the current stream of the tensors' device (no ``torch.cuda.Stream`` object is
built), switches the current device only when the tensors lie on another
one, and raises ``RuntimeError`` on the error code the C function returns; the
wrapper counts the launch after it. A build that fails raises from
``_build``, the launcher's too; nothing falls back to another path, ctypes
included.
"""

from __future__ import annotations

import ctypes

import torch

from raytracingtest_tpu_torch import _build

# the launcher's letter for each argument type the libraries declare
# (ctypes.c_longlong is ctypes.c_long where the two have one size)
KINDS = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_longlong: "l",
         ctypes.c_float: "f"}


def kinds(argtypes) -> str:
    """The launcher's kinds of a ctypes function's `argtypes`."""
    try:
        return "".join(KINDS[t] for t in argtypes)
    except KeyError as missing:
        raise TypeError(f"the launcher takes no argument of {missing}") from None


def bind(cfn):
    """The launcher's call of the declared ctypes function `cfn` (an entry
    point returning an int): same arguments, same result."""
    if cfn.restype is not ctypes.c_int:
        raise TypeError(f"{cfn.__name__} returns {cfn.restype}, not an int")
    return _build.launch_lib().bind(ctypes.cast(cfn, ctypes.c_void_p).value,
                                    kinds(cfn.argtypes))


def check_tensors(device, specs) -> None:
    """Raise ``ValueError``, naming the argument, unless every `(name,
    tensor, dtype, shape)` of `specs` is a contiguous `dtype` tensor of
    `shape` (a tuple or a ``torch.Size``) on `device`."""
    for name, t, dtype, shape in specs:
        if (t.device != device or t.dtype != dtype or t.shape != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: expected contiguous {dtype} {tuple(shape)} on "
                f"{device}, got {'' if t.is_contiguous() else 'non-contiguous '}"
                f"{t.dtype} {tuple(t.shape)} on {t.device}")


class Kernel:
    """The launcher of the C function `name` of the library that `lib_fn`
    (a function of ``_build``) returns."""

    def __init__(self, name: str, lib_fn):
        self.name = name
        self._lib_fn = lib_fn
        self._fn = None
        self._raw_stream = None
        self._current_device = None

    def check(self, device, specs) -> None:
        """Raise ``ValueError`` unless `device` is a CUDA device and `specs`
        pass ``check_tensors`` on it."""
        if device.type != "cuda":
            raise ValueError(
                f"the {self.name} kernel takes CUDA tensors, got {device}")
        check_tensors(device, specs)

    def _resolve(self):
        self._fn = bind(getattr(self._lib_fn(), self.name))
        self._raw_stream = torch._C._cuda_getCurrentRawStream
        # torch.cuda.current_device without its Python wrapper: a kernel's
        # tensors lie on the card, so CUDA is initialised by now
        self._current_device = torch._C._cuda_getDevice
        return self._fn

    def __call__(self, device, *args) -> None:
        """Launch on the current stream of `device`, the ``.device`` of the
        CUDA tensors `args` point into; the stream is appended as the last
        argument."""
        fn = self._fn or self._resolve()
        index = device.index
        if index == self._current_device():
            err = fn(*args, self._raw_stream(index))
        else:
            with torch.cuda.device(index):
                err = fn(*args, self._raw_stream(index))
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError {err}")
