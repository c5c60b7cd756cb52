"""Information-bit source and the per-sub-chunk random streams.

The JAX package derives every chunk's randomness from
``fold_in(fold_in(root, snr_milli), launch)`` and a split per sub-chunk.
Here one ``torch.Generator`` per sub-chunk is seeded from the same
coordinates, so a sweep is deterministic for a given ``seed`` and a
launch can be replayed on its own.  The streams differ from JAX's (another
generator), so the two packages agree statistically, not bitwise.
"""

from __future__ import annotations

import hashlib
import struct

import torch


def chunk_seed(seed: int, snr: float, launch: int, sub: int) -> int:
    """Deterministic 63-bit generator seed for one sub-chunk of a launch.

    ``snr`` enters as ``round(snr * 1000) & 0xFFFFFFFF``, the SNR key of
    the JAX harness (negative SNRs wrap the same way).
    """
    snr_key = int(round(snr * 1000)) & 0xFFFFFFFF
    data = struct.pack("<qIqq", int(seed), snr_key, int(launch), int(sub))
    digest = hashlib.blake2b(data, digest_size=8).digest()
    return int.from_bytes(digest, "little") & 0x7FFF_FFFF_FFFF_FFFF


def make_generator(seed: int, device: torch.device | str) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def random_bits(
    gen: torch.Generator, shape: tuple[int, ...], device: torch.device | str
) -> torch.Tensor:
    """iid uniform bits as int8 of the given shape."""
    return torch.randint(0, 2, shape, generator=gen, device=device, dtype=torch.int8)


def random_symbols(
    gen: torch.Generator, qary: int, shape: tuple[int, ...], device: torch.device | str
) -> torch.Tensor:
    """iid uniform q-ary symbols in [0, qary) as int32 (reference
    ``SourceSink::GetSymStr``, sourcesink.cc:12-19: the same distribution
    as its rejection loop, drawn directly)."""
    return torch.randint(0, qary, shape, generator=gen, device=device, dtype=torch.int32)
