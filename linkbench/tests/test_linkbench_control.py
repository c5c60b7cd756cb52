"""The control, the plain reference in bfloat16 put in the program's
place, fails a limit of each cell.  On the card at the cells' own size
it runs through ``python -m linkbench.control`` (PERF.md gives its
readings)."""

import pytest
import torch

from linkbench import judge, spec
from linkbench.control import control_numbers

CASES = [("peg2304-qpsk.blind", 5.0, 10.0), ("nr-bg2-16qam.blind", 14.0, 19.0),
         ("nr-bg2-16qam.known", 12.0, 18.0)]


def fails(cell_name: str, numbers: dict) -> list:
    """The numbers over their limits, by the rule a run is judged by."""
    correct, checks = judge.verdict(spec.load_cell(cell_name), numbers)
    over = [k for k, c in checks.items() if c["value"] > c["limit"]]
    assert correct == (not over)
    return over


@pytest.mark.parametrize("name,lo,hi", CASES)
def test_control_fails_a_limit(name, lo, hi, tiny_overrides):
    numbers = control_numbers(name, 7, "cpu", tiny_overrides(lo, hi, batch=32, blocks=32))
    assert fails(name, numbers), numbers


@pytest.mark.cuda
def test_control_fails_a_limit_on_the_card(tiny_overrides):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    name = "nr-bg2-16qam.blind"
    numbers = control_numbers(name, 7, "cuda", tiny_overrides(14.0, 24.0, batch=256, blocks=256))
    assert fails(name, numbers), numbers
