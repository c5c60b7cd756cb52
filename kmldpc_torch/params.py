"""The chain's parameter tensors: encoder slab, decoder tables and, for the
layered schedule, its layer tables."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .code.ldpc import LDPCCode
from .decoder.bp import DecoderTables
from .decoder.minsum import MinsumTables, minsum_tables
from .ops.encode import encoder_table


@dataclasses.dataclass(frozen=True)
class ChainParams:
    gen_t: torch.Tensor  # [K, chk] f32 encoder slab
    dec: DecoderTables
    ms: MinsumTables | None = None  # only for schedule = "layered-minsum"


def make_chain_params(
    code: LDPCCode, device: torch.device | str = "cpu", schedule: str = "flooding"
) -> ChainParams:
    """Parameters of ``code`` on ``device`` for the final decode's
    ``schedule``; "layered-minsum" adds the layered min-sum tables."""
    return ChainParams(
        gen_t=encoder_table(code, device),
        dec=DecoderTables.from_code(code, device),
        ms=minsum_tables(code, device=device) if schedule == "layered-minsum" else None,
    )


def _tables(d, device) -> DecoderTables:
    return DecoderTables.from_arrays(
        device=device, **{f: getattr(d, f) for f in DecoderTables.HOST_FIELDS}
    )


def from_jax_params(np_params, device: torch.device | str = "cpu") -> ChainParams:
    """The port's parameters from the JAX package's ``ChainParams``.

    ``np_params`` is that pytree with its leaves turned into NumPy arrays
    (``jax.tree.map(np.asarray, params)``): an object with ``gen_t``, a
    ``dec`` carrying the fields of the JAX ``DecoderTables`` (slot-major,
    degree-class and 5G) and an ``ms`` that is None or carries the JAX
    ``MinsumTables`` (``base``, the layer tables and the static ``qc``).
    Lets a test run both packages on identical parameters.
    """
    ms = np_params.ms
    if ms is not None:
        ms = MinsumTables.from_arrays(
            _tables(ms.base, device), ms.l_edge_idx, ms.l_edge_col, ms.l_mask, ms.qc, device
        )
    return ChainParams(
        gen_t=torch.tensor(np.asarray(np_params.gen_t, dtype=np.float32), device=device),
        dec=_tables(np_params.dec, device),
        ms=ms,
    )
