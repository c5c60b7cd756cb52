from .logging import SimLogger  # noqa: F401
