"""The least times the roofline shares hold device times against: the
card's peaks, kernel K1's count and the decoders' count.

Peaks.  Float32 issue rate: SMs x 128 lanes x the top SM clock, one
operation a lane a cycle.  The data sheet's 67 TFLOP/s for an H100 SXM
counts a fused multiply-add as two; the counts below are of single
operations (adds, compares, one special function), so they are held
against the issue rate, half of it.  HBM: 3.35 TB/s, the data sheet's
rate for the SXM part at its 700 W limit.

K1 (copied from ``chip_smoke.py``'s ``k1_bound_ms``, whose numbers are
PERF.md's kernel table): each assignment pass evaluates Nsym x M
distances of 6 float32 operations (2 subtractions, 2 products, a sum, a
compare); the bytes are the row read once (two float32 planes) and the 4
candidates written once (two float32 planes).  The passes counted are
those the inputs need: a row's assignment stops changing after some
passes, and the rest repeat it.

Decoder: operations per edge per iteration of the flooding sum-product
rule.  The variable node adds the edge's check message into the posterior
(1) and takes it out for the extrinsic message (1); the check node takes
its magnitude and sign (1), phi of the magnitude (1), its add into the
row's sum (1), the sum less its own term (1), phi of that (1) and the sign
product applied (1).  Special functions count once, as if as cheap as an
add, so the bound is the least the card could take.  Another check rule
needs its own count here, as the reference needs its decoder.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
K1_DISTANCE_OPS = 6
# the final decode's [tpu] schedule -> operations per edge per iteration
DECODE_OPS_PER_EDGE = {"flooding": 8}


def fp32_ops_per_s() -> float:
    """Single float32 operations the card issues per second at its top clock."""
    import torch

    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 128 * float(mhz) * 1e6


def k1_least_s(rows: int, nsym: int, m: int, passes: float, ops_per_s: float) -> float:
    """K1's least seconds for ``rows`` rows that need ``passes`` assignment
    passes in all."""
    ops_s = K1_DISTANCE_OPS * passes * nsym * m / ops_per_s
    bytes_s = (2 * 4 * rows * nsym + 2 * 4 * rows * 4) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s)


def decode_least_s(schedule: str, edges: int, iters: float, blocks: int, tx_len: int,
                   info_bits: int, ops_per_s: float) -> float | None:
    """The final decode's least seconds for ``blocks`` codewords that need
    ``iters`` iterations in all: the check rule's operations, or each
    codeword's channel LLRs read once (float32) and its decided info bits
    written once (a byte each); None for a schedule without a count."""
    per_edge = DECODE_OPS_PER_EDGE.get(schedule)
    if per_edge is None:
        return None
    ops_s = per_edge * edges * iters / ops_per_s
    bytes_s = blocks * (4 * tx_len + info_bits) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s)
