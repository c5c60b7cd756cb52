"""Batched systematic LDPC encoder (port of ``kmldpc_tpu/ops/encode.py``).

Parity bits are one float32 product of the info bits with the [K, chk]
generator slab, then mod 2.  The counts are at most ``code_dim`` (1152 for
PEG2304), exact in float32, and the 0/1 operands are exact even under TF32.

Codeword order, as in the reference: classic ``cc = [parity | info]``;
5G ``cc_full = [info | parity]``, of which ``cc_full[2Z:]`` is transmitted
(the first two lifting blocks are punctured).  ``active=False`` transmits
the all-zero codeword.
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

    uu: [B, K] int8.  cc_full: [B, num_col] int8 (before puncturing);
    cc_tx: [B, tx_len] int8, what enters the mapper.
    """
    punct = code.punct

    def encode(uu: torch.Tensor, gen_t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if not active:
            cc = torch.zeros((uu.shape[0], code.num_col), dtype=torch.int8, device=uu.device)
            return cc, cc[:, punct:]
        counts = uu.to(torch.float32) @ gen_t
        parity = torch.remainder(counts, 2.0).to(torch.int8)
        info = uu.to(torch.int8)
        cc = torch.cat([info, parity] if code.is_5g else [parity, info], dim=1)
        return cc, cc[:, punct:]

    return encode
