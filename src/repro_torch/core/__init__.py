# The stencil DSL, program graph and compilation pipeline of the PyTorch /
# CUDA port, module for module beside the reference package.
from .hardware import (  # noqa: F401
    H100,
    Hardware,
    available_hardware,
    get_hardware,
    register_hardware,
    resolve_hardware,
)
from .graph import FieldDecl, Node, State, StencilProgram, rename_stencil  # noqa: F401
from .backend import (  # noqa: F401
    Backend,
    BatchSpec,
    available_backends,
    compile_program,
    compile_stencil,
    get_backend,
    parse_batch,
    register_backend,
    resolve_device,
)
