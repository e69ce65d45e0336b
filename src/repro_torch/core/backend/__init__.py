# The compilation pipeline of the port: Backend protocol + registry, the
# plain PyTorch and CUDA lowerings behind it, and the compile_program entry
# point.  This is the only package allowed to touch a lowering directly.
from ..hardware import (  # noqa: F401
    H100,
    Hardware,
    available_hardware,
    get_hardware,
    register_hardware,
    resolve_hardware,
)
from .base import (  # noqa: F401
    Backend,
    available_backends,
    get_backend,
    register_backend,
    resolve_device,
)
from .batching import BatchSpec, parse_batch  # noqa: F401
from .cache import stencil_fingerprint  # noqa: F401
from .compile import compile_program, compile_stencil  # noqa: F401
