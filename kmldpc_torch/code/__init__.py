from .ldpc import LDPCCode, compile_code, load_code  # noqa: F401
