from .chain import (  # noqa: F401
    ChainSpec,
    ChunkResult,
    build_backend_fn,
    build_chain_fn,
    build_frontend_fn,
    make_chunk_runner,
    make_multi_point_runner,
)
from .montecarlo import Simulator, SnrResult  # noqa: F401
