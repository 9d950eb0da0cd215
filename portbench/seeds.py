"""Streams drawn from ``--seed``: one independent seed for each use."""

from __future__ import annotations

import zlib

import numpy as np
import torch


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of run seed ``seed`` (any whole
    number; it may exceed 32 bits)."""
    state = np.random.SeedSequence(
        [int(seed) % (1 << 64), zlib.crc32(tag.encode())]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, tag))
    return g
