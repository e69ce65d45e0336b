"""The shared libraries of the standalone kernels, each built with ``nvcc``
at first use, like the stencil kernels, into its own directory under
``build/repro_torch/``, and bound with :mod:`ctypes`:

 * ``csrc/fv3_kernels.cu`` — K6 ``tridiag_kernel``, K7 ``fvt_flux_kernel``;
 * ``csrc/lm_kernels.cu`` — K8 ``flash_attention_wgmma_kernel`` (bf16) and
   ``flash_attention_fwd_kernel`` (f32), K9 ``rmsnorm_kernel`` (plain and
   residual), K10 ``ssm_state_scan_kernel``, and the backward kernels of
   K8 (``flash_attention_bwd_*``), K9 (``rmsnorm_bwd_*``) and K10
   (``ssm_state_scan_bwd_kernel``).
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ..core.backend.cuda import build_library

#: launches of each kernel since the last :func:`reset_launches`; a wrapper
#: adds one where it launches its kernel and nowhere else
#: (``flash_attention_window``, ``flash_attention_bwd_window``: those of
#: K8's launches that run its window instance, 0 < window < S, also
#: counted under ``flash_attention`` and ``flash_attention_bwd``; a
#: backward wrapper's call, ``*_bwd``, is one count for the kernels it
#: launches: K8's three, K9's two, K10's one)
LAUNCHES = {"tridiag": 0, "fvt_flux": 0, "flash_attention": 0,
            "flash_attention_window": 0, "flash_attention_bwd": 0,
            "flash_attention_bwd_window": 0, "rmsnorm": 0,
            "rmsnorm_residual": 0, "rmsnorm_bwd": 0,
            "rmsnorm_residual_bwd": 0, "ssm_state_scan": 0,
            "ssm_state_scan_bwd": 0}

#: dtype codes of the LM kernels' C interface
LM_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: the bound libraries, loaded at first use (:func:`load_library`,
#: :func:`load_lm_library`) and kept for every later call
FV3: ctypes.CDLL | None = None
LM: ctypes.CDLL | None = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def bind_library(path) -> ctypes.CDLL:
    """Load a build of ``fv3_kernels.cu`` and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("launch_tridiag_f32", "launch_tridiag_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 6 + [i32, i64, i32, ptr]
        fn.restype = ctypes.c_int
    lib.launch_fvt_flux.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
    lib.launch_fvt_flux.restype = ctypes.c_int
    lib.fv3_error_string.argtypes = [ctypes.c_int]
    lib.fv3_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the library."""
    global FV3
    if FV3 is None:
        FV3 = bind_library(build_library("fv3_kernels"))
    return FV3


def bind_lm_library(path) -> ctypes.CDLL:
    """Load a build of ``lm_kernels.cu`` and declare its C interface.  Its
    entries only enqueue work and return within microseconds, so they keep
    the interpreter lock (``ctypes.PyDLL``): releasing it and taking it back
    is a part of a decode step's K9 call worth saving."""
    lib = ctypes.PyDLL(str(path))
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib.launch_flash_attention.argtypes = ([ptr] * 5 + [i32] * 6
                                           + [f32, i32, ptr])
    lib.launch_flash_attention.restype = ctypes.c_int
    lib.launch_flash_attention_bwd.argtypes = ([ptr] * 10 + [i32] * 6
                                               + [f32, i32, ptr])
    lib.launch_flash_attention_bwd.restype = ctypes.c_int
    lib.launch_rmsnorm_bwd.argtypes = ([ptr] * 8
                                       + [i32, i32, i64, i32, f32, i32, ptr])
    lib.launch_rmsnorm_bwd.restype = ctypes.c_int
    lib.launch_rmsnorm.argtypes = [ptr] * 3 + [i32, i32, i64, i32, f32, ptr]
    lib.launch_rmsnorm.restype = ctypes.c_int
    lib.launch_rmsnorm_residual.argtypes = ([ptr] * 5
                                            + [i32, i32, i64, i32, f32, ptr])
    lib.launch_rmsnorm_residual.restype = ctypes.c_int
    lib.launch_ssm_state_scan.argtypes = [ptr] * 3 + [i32, i64, i64, i32, ptr]
    lib.launch_ssm_state_scan.restype = ctypes.c_int
    lib.launch_ssm_state_scan_bwd.argtypes = ([ptr] * 5
                                              + [i32, i64, i32, ptr])
    lib.launch_ssm_state_scan_bwd.restype = ctypes.c_int
    lib.lm_error_string.argtypes = [ctypes.c_int]
    lib.lm_error_string.restype = ctypes.c_char_p
    return lib


def load_lm_library() -> ctypes.CDLL:
    """Build (at first use) and load the LM kernels' library."""
    global LM
    if LM is None:
        LM = bind_lm_library(build_library("lm_kernels"))
    return LM


def refuse_grad(name: str, item: str, *tensors: torch.Tensor) -> None:
    """Raise RuntimeError where a kernel without a backward would be
    recorded for autograd (grad mode on and an input requiring grad): the
    kernel's output would carry no gradient, so it must not run, and its
    plain version must not stand in for it on the card.  ``item`` names
    the ROADMAP item that gives it a backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward kernel yet (ROADMAP "
                           f"queue 1, {item}); call it under torch.no_grad() "
                           "or on tensors that do not require grad")


def pointer(t: torch.Tensor) -> int:
    """The device address of a kernel's input, for :func:`launch`.  A
    ``DTensor`` (a shard of a parameter laid out on a mesh) is refused: its
    ``data_ptr()`` is not its shard's, and a kernel takes whole tensors
    (``parallel.sharding.Gathered`` gathers them)."""
    if type(t) is not torch.Tensor and is_dtensor(t):
        raise TypeError("a kernel takes whole plain tensors, not a DTensor "
                        "(gather it with parallel.sharding first)")
    return t.data_ptr()


def is_dtensor(t) -> bool:
    """A ``DTensor`` (none exists before its module is imported, so a plain
    run never pays for importing it)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def launch(name: str | None, fn, describe, device: int, *args) -> None:
    """Call a C launch entry, ``fn(*args, stream)``: ``stream`` is the
    caller's current stream of CUDA device ``device`` as a raw pointer, and
    the call runs with that device current, switched (and switched back)
    only where it is not.  A nonzero return is a refused launch (the C
    function returns ``cudaGetLastError()``; ``describe`` is its library's
    error-string function) and raises; else ``LAUNCHES[name]`` counts the
    launch.  ``name`` None: ``fn`` makes several launches and checks and
    counts them itself (a stencil's, ``CudaStencil.launch``).  The
    wrappers take their inputs' addresses through :func:`pointer`, so no
    ``DTensor`` reaches a launch.

    Both reads go through torch's private entries, the ones that
    ``torch.cuda.current_device`` and ``torch.cuda.current_stream`` call
    (``torch._C._cuda_getDevice``, ``torch._C._cuda_getCurrentRawStream``),
    without their Python layers or a ``torch.cuda.Stream`` object: a
    kernel of a few microseconds pays for those on every call
    (``tests/test_torch_cuda.py`` launches the kernels on a stream of
    their own)."""
    if torch._C._cuda_getDevice() != device:
        with torch.cuda.device(device):
            return launch(name, fn, describe, device, *args)
    rc = fn(*args, torch._C._cuda_getCurrentRawStream(device))
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{describe(rc).decode()}")
    if name is not None:
        LAUNCHES[name] += 1
