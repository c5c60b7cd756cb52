"""The chain's parameter tensors: encoder slab and decoder tables."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .code.ldpc import LDPCCode
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
    ``dec`` carrying the fields of the JAX ``DecoderTables`` (slot-major,
    degree-class and 5G).  Lets a test run both packages on identical
    parameters.
    """
    d = np_params.dec
    return ChainParams(
        gen_t=torch.tensor(np.asarray(np_params.gen_t, dtype=np.float32), device=device),
        dec=DecoderTables.from_arrays(
            device=device, **{f: getattr(d, f) for f in DecoderTables.HOST_FIELDS}
        ),
    )
