from .bp import DecodeResult, DecoderTables, count_failed_checks, phi  # noqa: F401
from .bp_em import flooding_decode_em, flooding_decode_two_phase  # noqa: F401
