"""The shared libraries of the standalone kernels, each built with ``nvcc``
at first use, like the stencil kernels, into its own directory under
``build/repro_torch/``, and bound with :mod:`ctypes`:

 * ``csrc/fv3_kernels.cu`` — K6 ``tridiag_kernel``, K7 ``fvt_flux_kernel``;
 * ``csrc/lm_kernels.cu`` — K8 ``flash_attention_wgmma_kernel`` (bf16) and
   ``flash_attention_fwd_kernel`` (f32), K9 ``rmsnorm_kernel`` (plain and
   residual), K10 ``ssm_state_scan_kernel``.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.backend.cuda import build_library

#: launches of each kernel since the last :func:`reset_launches`; a wrapper
#: adds one where it launches its kernel and nowhere else
LAUNCHES = {"tridiag": 0, "fvt_flux": 0, "flash_attention": 0, "rmsnorm": 0,
            "rmsnorm_residual": 0, "ssm_state_scan": 0}

#: dtype codes of the LM kernels' C interface
LM_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LIB: ctypes.CDLL | None = None
_LM_LIB: ctypes.CDLL | None = None


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
    global _LIB
    if _LIB is None:
        _LIB = bind_library(build_library("fv3_kernels"))
    return _LIB


def bind_lm_library(path) -> ctypes.CDLL:
    """Load a build of ``lm_kernels.cu`` and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib.launch_flash_attention.argtypes = [ptr] * 4 + [i32] * 6 + [f32, ptr]
    lib.launch_flash_attention.restype = ctypes.c_int
    lib.launch_rmsnorm.argtypes = [ptr] * 3 + [i32, i32, i64, i32, f32, ptr]
    lib.launch_rmsnorm.restype = ctypes.c_int
    lib.launch_rmsnorm_residual.argtypes = ([ptr] * 5
                                            + [i32, i32, i64, i32, f32, ptr])
    lib.launch_rmsnorm_residual.restype = ctypes.c_int
    lib.launch_ssm_state_scan.argtypes = [ptr] * 3 + [i32, i64, i64, i32, ptr]
    lib.launch_ssm_state_scan.restype = ctypes.c_int
    lib.lm_error_string.argtypes = [ctypes.c_int]
    lib.lm_error_string.restype = ctypes.c_char_p
    return lib


def load_lm_library() -> ctypes.CDLL:
    """Build (at first use) and load the LM kernels' library."""
    global _LM_LIB
    if _LM_LIB is None:
        _LM_LIB = bind_lm_library(build_library("lm_kernels"))
    return _LM_LIB


def check_launch(describe, rc: int, what: str) -> None:
    """Raise if a launch was refused (the C function returns
    ``cudaGetLastError()``); ``describe`` is the library's error-string
    function."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{describe(rc).decode()}")
