"""Fixtures of the benchmark's CPU tests (``python -m pytest linkbench/tests``).

Runs are cut to a few codewords through ``run_cell``'s ``overrides``; the
real command refuses the CPU.  Tests that need the card carry the ``cuda``
marker and skip without one.
"""

import pytest


def tiny(lo: float, hi: float, batch: int = 8, blocks: int = 16) -> dict:
    """Overrides that cut a cell's sweep to a few codewords a point."""
    return {"range": {"minimum_snr": lo, "maximum_snr": hi, "maximum_block_number": blocks},
            "tpu": {"batch": batch}}


@pytest.fixture
def tiny_overrides():
    return tiny
