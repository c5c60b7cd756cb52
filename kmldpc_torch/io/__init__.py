from .constellation import Constellation, parse_constellation  # noqa: F401
from .hmatrix import ParityCheckMatrix, parse_hmatrix  # noqa: F401
