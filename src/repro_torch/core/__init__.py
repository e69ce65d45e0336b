# The stencil DSL, program graph, optimizer and compilation pipeline of the
# PyTorch / CUDA port, module for module beside the reference package.
from .hardware import (  # noqa: F401
    H100,
    Hardware,
    P100,
    TPU_V4,
    TPU_V5E,
    V100,
    available_hardware,
    get_hardware,
    register_hardware,
    resolve_hardware,
)
from .graph import FieldDecl, Node, State, StencilProgram, rename_stencil  # noqa: F401
from .backend import (  # noqa: F401
    Backend,
    BatchSpec,
    TuningCache,
    available_backends,
    compile_program,
    compile_stencil,
    default_cache,
    get_backend,
    parse_batch,
    register_backend,
    resolve_device,
    set_default_cache,
)
from .rewrite import (  # noqa: F401
    OPT_LADDERS,
    FunctionRule,
    Match,
    PassContext,
    PassStats,
    Pipeline,
    PipelineReport,
    RewriteRule,
    RewriteTraceEntry,
    Stage,
    available_rules,
    get_rule,
    optimize_program,
    pipeline_for_level,
    register_rule,
    run_fixpoint,
)
from .perfmodel import (  # noqa: F401
    KernelReport,
    format_report,
    node_bound_seconds,
    node_bytes,
    node_flops,
    program_bound_seconds,
    program_bytes,
    program_report,
)
from .transfer_tuning import (  # noqa: F401
    Pattern,
    Phase1Result,
    TransferResult,
    transfer,
    transfer_tune,
    tune_cutouts,
)
from .transforms import (  # noqa: F401
    can_otf_fuse,
    can_subgraph_fuse,
    otf_fuse,
    prune_transients,
    strength_reduce_pow,
    strength_reduce_program,
    subgraph_fuse,
)
from .autotune import (  # noqa: F401
    TuneResult,
    model_cost,
    tune_member_chunk,
    tune_program_chunk,
    tune_stencil,
    wallclock,
)
from .stencil import (  # noqa: F401
    at_found,
    index_search,
    solver_k_blockable,
)
from .analysis import (  # noqa: F401
    AnalysisError,
    FusionLegalityError,
    SourceLocation,
    VerificationError,
    Violation,
    check_halo,
    check_lints,
    check_races,
    check_wellformed,
    lint_program,
    resolve_verify_mode,
    verify_program,
)
