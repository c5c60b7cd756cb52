"""The chain's parameter tensors: encoder slab and decoder tables."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kmldpc_tpu.code.ldpc import LDPCCode

from .decoder.bp import DecoderTables
from .ops.encode import encoder_table


@dataclasses.dataclass(frozen=True)
class ChainParams:
    gen_t: torch.Tensor  # [K, chk] f32 encoder slab
    dec: DecoderTables


def make_chain_params(code: LDPCCode, device: torch.device | str = "cpu") -> ChainParams:
    return ChainParams(
        gen_t=encoder_table(code, device), dec=DecoderTables.from_code(code, device)
    )


def from_jax_params(np_params, device: torch.device | str = "cpu") -> ChainParams:
    """The port's parameters from the JAX package's ``ChainParams``.

    ``np_params`` is that pytree with its leaves turned into NumPy arrays
    (``jax.tree.map(np.asarray, params)``): an object with ``gen_t`` and a
    ``dec`` carrying the slot-major fields of ``DecoderTables``.  Lets a
    test run both packages on identical parameters.
    """
    d = np_params.dec
    return ChainParams(
        gen_t=torch.tensor(np.asarray(np_params.gen_t, dtype=np.float32), device=device),
        dec=DecoderTables.from_arrays(
            num_col=d.num_col,
            num_row=d.num_row,
            code_dim=d.code_dim,
            info_start=d.info_start,
            perm_sm_c2r=d.perm_sm_c2r,
            col_mask_sm=d.col_mask_sm,
            row_mask_sm=d.row_mask_sm,
            row_edge_col=d.row_edge_col,
            device=device,
        ),
    )
