"""Measurement tools on the card: the counterparts of the JAX side's
``tools/microbench.py`` (decoder and k-means groups), ``snrfold_bench.py``,
``scaling.py`` and ``locality.py``, each run as
``python -m kmldpc_torch.tools.<name> [--device cuda|cpu]``."""
