"""Memory fault injection (paper §5.3).

Counterpart of ``repro.core.faults``. Fault model: random bit flips in the
stored byte image; ``#faulty bits = round(#bits * rate)``, positions drawn
uniformly with replacement and applied as an XOR, so a position drawn twice
cancels — what two upsets of the same DRAM cell do.

The host path (``sample_positions`` with an int seed, ``flip_bits_np``) is
NumPy and draws exactly the reference's positions. The device path
(:func:`inject_torch`, and :func:`inject_torch_rate` for the campaigns'
rate sweeps) draws from a ``torch.Generator`` and returns the positions
that ended up flipped, so a caller can count the blocks that took one or
two flips.
"""
from __future__ import annotations

import numpy as np
import torch


def n_faults(n_bits: int, rate: float) -> int:
    return int(round(n_bits * rate))


def sample_positions(n_bits: int, rate: float, seed: int) -> np.ndarray:
    """``round(n_bits * rate)`` uniform positions, with replacement (NumPy
    ``default_rng(seed)``, the reference's host sampler)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_bits, size=n_faults(n_bits, rate),
                        dtype=np.int64)


def flip_bits_np(stored: np.ndarray, positions: np.ndarray) -> np.ndarray:
    """XOR-flip the given global bit positions of a uint8 byte image;
    repeated positions cancel pairwise."""
    out = np.array(stored, dtype=np.uint8, copy=True).reshape(-1)
    byte_idx = positions // 8
    bit = (np.uint8(1) << (positions % 8).astype(np.uint8))
    np.bitwise_xor.at(out, byte_idx, bit)
    return out.reshape(stored.shape)


def inject(stored: np.ndarray, rate: float, seed: int) -> np.ndarray:
    """Inject random bit flips at ``rate`` into a uint8 byte image (host)."""
    flat = np.asarray(stored, dtype=np.uint8).reshape(-1)
    pos = sample_positions(flat.size * 8, rate, seed)
    return flip_bits_np(flat, pos).reshape(stored.shape)


BLOCK_BITS = 64  # one (64,57,1) code block


def flip_positions_(flat: torch.Tensor, positions: torch.Tensor, *,
                    one_per_block: bool = False,
                    hit_blocks=None) -> torch.Tensor:
    """XOR the given global bit positions into a flat uint8 tensor IN PLACE
    and return the positions that stay flipped (drawn an odd number of
    times), sorted. With ``one_per_block`` only the lowest of those that
    fall in one 64-bit code block is flipped, so every flip is one the
    (64,57,1) code corrects. ``hit_blocks``, a bool tensor over the image's
    64-bit blocks, carries that guarantee across repeated injections: a
    block already marked takes no new flip, and every flipped block is
    marked (in place)."""
    uniq, counts = torch.unique(positions, return_counts=True)
    live = uniq[counts % 2 == 1]
    if one_per_block and live.numel():
        blk = live // BLOCK_BITS
        first = torch.ones_like(live, dtype=torch.bool)
        first[1:] = blk[1:] != blk[:-1]
        live = live[first]
    if hit_blocks is not None and live.numel():
        live = live[~hit_blocks[live // BLOCK_BITS]]
        hit_blocks[live // BLOCK_BITS] = True
    if live.numel():
        byte_idx, inv = torch.unique(live // 8, return_inverse=True)
        bits = torch.ones_like(live) << (live % 8)
        # distinct bits of one byte: their sum is their OR is their XOR
        mask = torch.zeros_like(byte_idx).index_add_(0, inv, bits)
        flat[byte_idx] ^= mask.to(torch.uint8)
    return live


def inject_torch(stored: torch.Tensor, rate: float,
                 generator: torch.Generator, *, one_per_block: bool = False,
                 hit_blocks=None):
    """Device injection at a Python-float rate (``one_per_block`` and
    ``hit_blocks``: see :func:`flip_positions_`).

    -> ``(flipped copy of stored, positions)`` where ``positions`` (int64,
    sorted) are the global bit positions of the flat image that end up
    flipped.
    """
    flat = stored.reshape(-1).clone()
    n_bits = flat.numel() * 8
    n = n_faults(n_bits, rate)
    pos = torch.randint(0, n_bits, (n,), generator=generator,
                        device=stored.device, dtype=torch.int64)
    live = flip_positions_(flat, pos, one_per_block=one_per_block,
                           hit_blocks=hit_blocks)
    return flat.reshape(stored.shape), live


def rate_positions(n_bits: int, rate: float, generator: torch.Generator,
                   max_rate: float, device=None) -> torch.Tensor:
    """The draw of :func:`inject_torch_rate`: ``n_faults(n_bits, max_rate)``
    uniform positions from ``generator``, of which the first
    ``round(n_bits * rate)`` are returned (``rate <= max_rate``). A lower
    rate's positions are a prefix of a higher rate's from the same
    generator state; repeats are kept (the XOR cancels them)."""
    if rate > max_rate:
        raise ValueError(f"rate {rate} exceeds the sample budget's max_rate "
                         f"{max_rate}")
    n_max = n_faults(n_bits, max_rate)
    pos = torch.randint(0, max(n_bits, 1), (n_max,), generator=generator,
                        device=device, dtype=torch.int64)
    return pos[: n_faults(n_bits, rate)]


def inject_torch_rate(stored: torch.Tensor, rate: float,
                      generator: torch.Generator, max_rate: float):
    """Device injection for a campaign's rate sweep (the reference's
    ``inject_jax_rate``): the sample budget is fixed by ``max_rate``, so
    every rate of a sweep draws the same number of positions from the
    generator, and the first ``round(n_bits * rate)`` of them are XORed in
    through :func:`flip_positions_` (repeats cancel). No per-bit parity
    vector is built: the positions are applied directly.

    -> ``(flipped copy of stored, positions)``, the positions that end up
    flipped (sorted)."""
    flat = stored.reshape(-1).clone()
    pos = rate_positions(flat.numel() * 8, rate, generator, max_rate,
                         device=stored.device)
    live = flip_positions_(flat, pos)
    return flat.reshape(stored.shape), live
