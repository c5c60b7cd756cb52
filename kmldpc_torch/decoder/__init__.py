from .bp import (  # noqa: F401
    DecodeResult,
    DecoderTables,
    count_failed_checks,
    flooding_decode,
    make_flooding_decoder,
    phi,
)
from .bp_em import flooding_decode_em, two_phase_generic  # noqa: F401
from .minsum import MinsumTables, layered_minsum_decode, minsum_tables  # noqa: F401
