"""Frozen copy of the random streams a launch draws from.

One ``torch.Generator`` per sub-chunk, seeded from ``chunk_seed(seed, snr,
launch, sub)``, on the device the launch ran on; per sub-chunk the draws
are, in this order:

    info bits   randint(0, 2, (B, K), int8)
    gains h     randn((B, 2)) float32, scaled by sqrt(1/2) afterwards
                (not drawn without fading: h = 1)
    noise       randn((B, Nsym, 2)) float32, scaled by sigma/sqrt(2)

The same generator calls on the same device give the same numbers, so the
reference sees exactly the inputs the launch saw and does everything after
the draws in its own precision.  Kept apart from the program so that a
change there cannot move the yardstick.
"""

from __future__ import annotations

import hashlib
import struct
from typing import NamedTuple

import torch


class Draws(NamedTuple):
    uu: torch.Tensor  # [B, K] int8 info bits
    h: torch.Tensor | None  # [B, 2] float32 standard normals; None without fading
    noise: torch.Tensor  # [B, Nsym, 2] float32 standard normals


def chunk_seed(seed: int, snr: float, launch: int, sub: int) -> int:
    """63-bit generator seed of one sub-chunk: blake2b over
    ``(seed, round(snr * 1000) mod 2**32, launch, sub)``."""
    snr_key = int(round(snr * 1000)) & 0xFFFFFFFF
    data = struct.pack("<qIqq", int(seed), snr_key, int(launch), int(sub))
    digest = hashlib.blake2b(data, digest_size=8).digest()
    return int.from_bytes(digest, "little") & 0x7FFF_FFFF_FFFF_FFFF


def draw(seed: int, snr: float, launch: int, sub: int, batch: int, info_bits: int,
         nsym: int, fading: bool, device: torch.device | str) -> Draws:
    """The draws of sub-chunk ``sub`` of launch ``launch`` at ``snr``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(chunk_seed(seed, snr, launch, sub))
    uu = torch.randint(0, 2, (batch, info_bits), generator=gen, device=device, dtype=torch.int8)
    h = torch.randn((batch, 2), generator=gen, device=device) if fading else None
    noise = torch.randn((batch, nsym, 2), generator=gen, device=device)
    return Draws(uu, h, noise)
