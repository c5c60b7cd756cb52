"""Batched systematic LDPC encoder (port of ``kmldpc_tpu/ops/encode.py``).

Parity bits are one float32 product of the info bits with the [K, chk]
generator slab, then mod 2.  The counts are at most ``code_dim`` (1152 for
PEG2304), exact in float32, and the 0/1 operands are exact even under TF32.
Codeword order is the classic ``[parity | info]``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..code.ldpc import LDPCCode


def encoder_table(code: LDPCCode, device: torch.device | str = "cpu") -> torch.Tensor:
    """The [K, chk] f32 generator slab."""
    return torch.tensor(code.parity_gen.T.astype(np.float32), device=device)


def make_encoder(
    code: LDPCCode, active: bool = True
) -> Callable[[torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]:
    """Returns ``encode(uu, gen_t) -> (cc_full, cc_tx)``.

    uu: [B, K] int8.  cc_full: [B, num_col] int8; cc_tx: the transmitted
    word, equal to cc_full for the classic (unpunctured) codes.
    ``active=False`` transmits the all-zero codeword.
    """
    if code.is_5g:
        raise NotImplementedError(
            "5G codes are not ported yet "
            "(ROADMAP.md Queue 1, 'degree-class core and 5G')"
        )

    def encode(uu: torch.Tensor, gen_t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if not active:
            cc = torch.zeros((uu.shape[0], code.num_col), dtype=torch.int8, device=uu.device)
            return cc, cc
        counts = uu.to(torch.float32) @ gen_t
        parity = torch.remainder(counts, 2.0).to(torch.int8)
        cc = torch.cat([parity, uu.to(torch.int8)], dim=1)
        return cc, cc

    return encode
