"""Faults planted in the timed path, to see ``correct`` come out false.

Each fault stands in for ``kmldpc_torch.sim.chain.two_phase_generic``, the
decode that every launch of every cell runs.  ``planted(name)`` puts one in
place for the length of a ``with`` block; the CPU tests plant them in tiny
runs, ``python -m linkbench.control --faults ...`` in runs at the cell's own
size on the card.
"""

from __future__ import annotations

import contextlib

import torch

from kmldpc_torch.sim import chain

REAL_DECODE = chain.two_phase_generic


def unchanged(decode, llr, iters, **kw):
    """The decode returns its state as it started: no iteration runs."""
    return decode(llr, 0)


def half_decoded(decode, llr, iters, **kw):
    """Half of the batch decoded, its results standing for the other half."""
    half = REAL_DECODE(decode, llr[: llr.shape[0] // 2], iters, **kw)
    return type(half)(*(torch.cat([f, f]) for f in half))


def altered(decode, llr, iters, **kw):
    """One decided bit of every codeword flipped where the decode returns it."""
    res = REAL_DECODE(decode, llr, iters, **kw)
    uu = res.uu_hat.clone()
    uu[:, 0] ^= 1
    return res._replace(uu_hat=uu)


def sixteenth(decode, llr, iters, **kw):
    """One decided bit flipped in every sixteenth codeword: too few wrong
    outcomes to lift soft_gap's 90th percentile; decode_gap catches them."""
    res = REAL_DECODE(decode, llr, iters, **kw)
    uu = res.uu_hat.clone()
    uu[::16, 0] ^= 1
    return res._replace(uu_hat=uu)


def iters_shifted(decode, llr, iters, **kw):
    """Every codeword's iteration count reported one too high, its decided
    bits as they are."""
    res = REAL_DECODE(decode, llr, iters, **kw)
    return res._replace(iters=res.iters + 1)


FAULTS = {f.__name__: f for f in (unchanged, half_decoded, altered, sixteenth, iters_shifted)}


@contextlib.contextmanager
def planted(name: str):
    """The fault ``name`` in the decode's place for the ``with`` block."""
    chain.two_phase_generic = FAULTS[name]
    try:
        yield
    finally:
        chain.two_phase_generic = REAL_DECODE
