"""A run with the timed path broken underneath comes out not correct, for
each fault a cell of this benchmark can have; the same run unbroken comes
out correct.  One chip a cell: there is no exchange between chips to
leave out.  The decode's faults are those of ``linkbench/faults.py``,
which ``python -m linkbench.control --faults`` also plants at the cells'
own size on the card."""

import pytest

import kmldpc_torch.sim.chain as chain
import kmldpc_torch.sim.montecarlo as montecarlo
from linkbench.faults import altered, half_decoded, iters_shifted, sixteenth, unchanged
from linkbench.run import run_cell

CASES = [("peg2304-qpsk.blind", 12.5, 15.0), ("nr-bg2-16qam.blind", 19.0, 21.5),
         ("nr-bg2-16qam.known", 18.0, 21.0)]
REAL_RUNNER = chain.make_chunk_runner


def half_counted(monkeypatch):
    """The counters taken over the first half of the batch and doubled."""
    drawn = []
    real_bits = chain.random_bits

    def bits(*args, **kw):
        drawn.append(real_bits(*args, **kw))
        return drawn[-1]

    def runner(*args, **kw):
        run = REAL_RUNNER(*args, **kw)

        def launch(*a):
            res = run(*a)
            uu = drawn[-1]
            errs = (uu != res.raw.uu_hat)[: uu.shape[0] // 2].sum(1)
            return res._replace(err_bit=2 * errs.sum(), err_blk=2 * (errs > 0).sum())

        launch.params, launch.blocks_per_launch = run.params, run.blocks_per_launch
        return launch

    monkeypatch.setattr(chain, "random_bits", bits)
    monkeypatch.setattr(chain, "make_chunk_runner", runner)
    monkeypatch.setattr(montecarlo, "make_chunk_runner", runner)


DECODE_FAULTS = [unchanged, half_decoded, altered, iters_shifted]


def run(name, lo, hi, tiny_overrides, batch=8, blocks=16):
    return run_cell(name, 977, 0.0, False, "cpu", tiny_overrides(lo, hi, batch, blocks))


@pytest.mark.parametrize("name,lo,hi", CASES)
def test_sound_run_is_correct(name, lo, hi, tiny_overrides):
    r = run(name, lo, hi, tiny_overrides)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("fault", DECODE_FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("name,lo,hi", CASES)
def test_broken_decode_is_not_correct(fault, name, lo, hi, tiny_overrides, monkeypatch):
    monkeypatch.setattr(chain, "two_phase_generic", fault)
    r = run(name, lo, hi, tiny_overrides)
    assert not r["correct"], r["readings"]


@pytest.mark.parametrize("name,lo,hi", [("peg2304-qpsk.blind", 5.0, 7.5),
                                         ("nr-bg2-16qam.blind", 14.0, 16.5),
                                         ("nr-bg2-16qam.known", 12.0, 15.0)])
def test_counters_over_half_the_batch_are_not_correct(name, lo, hi, tiny_overrides,
                                                      monkeypatch):
    """At the grids' lowest points, where codewords fail to decode."""
    half_counted(monkeypatch)
    r = run(name, lo, hi, tiny_overrides, batch=16, blocks=32)
    assert not r["correct"] and r["checks"]["counter_gap"]["value"] > 0 and r["failed"] > 0


@pytest.mark.parametrize("name,lo,hi", CASES)
def test_a_sixteenth_decoded_wrongly_is_not_correct(name, lo, hi, tiny_overrides, monkeypatch):
    monkeypatch.setattr(chain, "two_phase_generic", sixteenth)
    r = run(name, lo, hi, tiny_overrides, batch=32, blocks=32)
    assert not r["correct"]
    assert r["checks"]["decode_gap"]["value"] > r["checks"]["decode_gap"]["limit"]
