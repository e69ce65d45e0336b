# The compilation pipeline of the port: Backend protocol + registry, the
# plain PyTorch and CUDA lowerings behind it, the persistent tuning cache
# and the compile_program entry point.  This is the only package allowed to
# touch a lowering directly.
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
from .cache import (  # noqa: F401
    COST_MODEL_VERSION,
    TuningCache,
    default_cache,
    make_key,
    set_default_cache,
    stencil_fingerprint,
)
from .compile import compile_program, compile_stencil  # noqa: F401
