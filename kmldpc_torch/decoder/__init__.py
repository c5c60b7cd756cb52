from .bp import DecodeResult, DecoderTables, count_failed_checks, phi  # noqa: F401
from .bp_em import flooding_decode_em, two_phase_generic  # noqa: F401
from .minsum import MinsumTables, layered_minsum_decode, minsum_tables  # noqa: F401
