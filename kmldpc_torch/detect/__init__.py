from .kmeans import add_diagnostics, make_blind_estimator  # noqa: F401
from .kmeans_cuda import kmeans_estimate, make_blind_estimator_cuda  # noqa: F401
from .metric import make_ambiguity_selector  # noqa: F401
