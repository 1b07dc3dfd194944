"""In-place SEC-DED (64,57,1) codec: tables and the plain PyTorch version.

Counterpart of ``repro.core.ecc``: the in-place (64,57,1) code, the
standard (72,64,1) SEC-DED baseline (``encode72``/``decode72``, one check
byte per 8-byte block, stored out of place) and the parity-per-byte
"Parity Zero" baseline (``encode_parity8``/``decode_parity8``, one check
byte per 8 data bytes). The 7 check bits of each in-place block live in
bit 6 of bytes 0..6, which WOT-constrained int8 weights leave free (bit 6
== bit 7 there).

Code construction: GF(2)^7 has exactly 64 odd-weight vectors; each is the
parity-check column of one bit of the 64-bit word, the seven weight-1
columns at the in-place check positions. Distinct nonzero columns correct
any single flip; odd weight makes every double-flip syndrome even, hence
detected and never miscorrected.

The plain version works on whole 64-bit words: a block is loaded as one
little-endian ``int64`` (byte j at bits 8j..8j+7), so torch needs no
popcount — each syndrome bit is the parity of ``word & ROWMASK[k]``, found
by xor-folding. The CUDA kernels (``csrc/secded64.cuh``) compute the same
thing with ``__popcll`` and the same packed tables.
"""
from __future__ import annotations

import numpy as np
import torch

BLOCK_BYTES = 8
CHECK_BIT = 6  # bit index inside a byte that holds a check bit (bytes 0..6)


def _odd_weight_values(width: int) -> list[int]:
    return [v for v in range(1, 1 << width) if bin(v).count("1") % 2 == 1]


def _build_cols64() -> np.ndarray:
    """COLS[g] = 7-bit parity-check column of global bit g (g = byte*8 + bit)."""
    cols = np.zeros(64, dtype=np.uint8)
    check_positions = [i * 8 + CHECK_BIT for i in range(7)]
    for i, g in enumerate(check_positions):
        cols[g] = 1 << i
    rest = [v for v in _odd_weight_values(7) if bin(v).count("1") >= 3]
    if len(rest) != 57:
        raise AssertionError(len(rest))
    data_positions = [g for g in range(64) if g not in check_positions]
    for g, v in zip(data_positions, rest):
        cols[g] = v
    return cols


COLS64 = _build_cols64()  # (64,) uint8, values in [1, 127], all odd weight

# ROWMASK64[k, i]: bit b set iff COLS64[i*8+b] has bit k set.
ROWMASK64 = np.zeros((7, 8), dtype=np.uint8)
for _k in range(7):
    for _g in range(64):
        if (COLS64[_g] >> _k) & 1:
            ROWMASK64[_k, _g // 8] |= np.uint8(1 << (_g % 8))

COLS64_BYBYTE = COLS64.reshape(8, 8)

# --- packed forms, shared with csrc/secded64.cuh -----------------------------

# row k of ROWMASK64 as one little-endian 64-bit mask
ROWMASK64_PACKED = tuple(
    int(np.frombuffer(ROWMASK64[k].tobytes(), "<u8")[0]) for k in range(7))

# syndrome -> global bit to flip (255: not a single-flip syndrome)
SYN2BIT = np.full(128, 255, dtype=np.uint8)
for _g in range(64):
    SYN2BIT[COLS64[_g]] = _g

# bit 6 of bytes 0..6: the check-bit positions inside the 64-bit word
CHECK_MASK64 = sum(1 << (8 * i + CHECK_BIT) for i in range(7))


def _as_int64(u: int) -> int:
    """Reinterpret an unsigned 64-bit value as a signed one (torch int64)."""
    return u - (1 << 64) if u >= 1 << 63 else u


def _tables(device) -> dict:
    """int64 lookup tables on ``device``, built once per device."""
    key = str(device)
    t = _TABLE_CACHE.get(key)
    if t is None:
        flip = [0] * 128
        spread = [0] * 128
        for syn in range(128):
            if SYN2BIT[syn] != 255:
                flip[syn] = _as_int64(1 << int(SYN2BIT[syn]))
            spread[syn] = sum(((syn >> i) & 1) << (8 * i + CHECK_BIT)
                              for i in range(7))
        t = {"rowmask": [_as_int64(m) for m in ROWMASK64_PACKED],
             "flip": torch.tensor(flip, dtype=torch.int64, device=device),
             "spread": torch.tensor(spread, dtype=torch.int64, device=device)}
        _TABLE_CACHE[key] = t
    return t


_TABLE_CACHE: dict = {}


def _words(blocks: torch.Tensor) -> torch.Tensor:
    """(..., 8) uint8 -> (...,) int64 little-endian words."""
    if blocks.dtype != torch.uint8 or blocks.shape[-1] != BLOCK_BYTES:
        raise ValueError(f"expected (..., 8) uint8 blocks, got "
                         f"{tuple(blocks.shape)} {blocks.dtype}")
    return blocks.contiguous().view(torch.int64).squeeze(-1)


def _bytes(words: torch.Tensor) -> torch.Tensor:
    """(...,) int64 -> (..., 8) uint8."""
    return words.unsqueeze(-1).view(torch.uint8)


def _parity64(x: torch.Tensor) -> torch.Tensor:
    """Parity of each int64 word (xor-fold; arithmetic shifts only pollute
    bits above the ones each fold keeps) -> int64 0/1."""
    for s in (32, 16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return x & 1


def _syndrome64(words: torch.Tensor) -> torch.Tensor:
    """(...,) int64 words -> (...,) int64 syndromes in [0, 128)."""
    syn = torch.zeros_like(words)
    for k, m in enumerate(_tables(words.device)["rowmask"]):
        syn |= _parity64(words & m) << k
    return syn


def _restore_words(words: torch.Tensor) -> torch.Tensor:
    """bit 6 := bit 7 on bytes 0..6 of each word."""
    m = CHECK_MASK64
    return (words & ~m) | ((words >> 1) & m)


def restore_sign_bits(blocks: torch.Tensor) -> torch.Tensor:
    """Copy bit7 -> bit6 for bytes 0..6 of each (..., 8) uint8 block."""
    return _bytes(_restore_words(_words(blocks)))


def encode64(blocks: torch.Tensor) -> torch.Tensor:
    """Encode WOT-compliant (..., 8) uint8 blocks: overwrite bit 6 of bytes
    0..6 with the check bits."""
    zeroed = _words(blocks) & ~CHECK_MASK64
    syn = _syndrome64(zeroed)
    return _bytes(zeroed | _tables(blocks.device)["spread"][syn])


def decode64_words(words: torch.Tensor):
    """Word form of :func:`decode64`: (...,) int64 -> (decoded words,
    single bool, double bool)."""
    syn = _syndrome64(words)
    single = _parity64(syn).bool()        # odd-weight syndrome: one flip
    double = (syn != 0) & ~single
    # the flip table is zero for every syndrome that is not a column
    corrected = words ^ _tables(words.device)["flip"][syn]
    return _restore_words(corrected), single, double


def decode64(blocks: torch.Tensor):
    """Decode in-place SEC-DED blocks.

    Returns ``(weights_bytes (..., 8) uint8, single_corrected (...,) bool,
    double_detected (...,) bool)``, corrected and sign-restored.
    """
    dec, single, double = decode64_words(_words(blocks))
    return _bytes(dec), single, double


# ---------------------------------------------------------------------------
# (72, 64, 1) standard SEC-DED baseline
# ---------------------------------------------------------------------------


def _build_cols72() -> np.ndarray:
    """COLS72[g] = 8-bit column of data bit g (g in [0, 64)); the check
    columns are the 8 weight-1 vectors (the separate check byte)."""
    vals = [v for v in _odd_weight_values(8) if bin(v).count("1") >= 3]
    if len(vals) < 64:
        raise AssertionError(len(vals))
    return np.asarray(vals[:64], dtype=np.uint8)


COLS72 = _build_cols72()
ROWMASK72 = np.zeros((8, 8), dtype=np.uint8)
for _k in range(8):
    for _g in range(64):
        if (COLS72[_g] >> _k) & 1:
            ROWMASK72[_k, _g // 8] |= np.uint8(1 << (_g % 8))
COLS72_BYBYTE = COLS72.reshape(8, 8)
ROWMASK72_PACKED = tuple(
    int(np.frombuffer(ROWMASK72[k].tobytes(), "<u8")[0]) for k in range(8))


def _tables72(device) -> dict:
    key = str(device)
    t = _TABLE_CACHE.get(("72", key))
    if t is None:
        flip = [0] * 256
        for g in range(64):
            flip[int(COLS72[g])] = _as_int64(1 << g)
        t = {"rowmask": [_as_int64(m) for m in ROWMASK72_PACKED],
             "flip": torch.tensor(flip, dtype=torch.int64, device=device)}
        _TABLE_CACHE[("72", key)] = t
    return t


def _syndrome72(words: torch.Tensor) -> torch.Tensor:
    syn = torch.zeros_like(words)
    for k, m in enumerate(_tables72(words.device)["rowmask"]):
        syn |= _parity64(words & m) << k
    return syn


def encode72(blocks: torch.Tensor) -> torch.Tensor:
    """The check byte of each 8-byte data block: (..., 8) uint8 -> (...,)
    uint8."""
    return _syndrome72(_words(blocks)).to(torch.uint8)


def decode72(blocks: torch.Tensor, checks: torch.Tensor):
    """Standard SEC-DED decode -> ``(data (..., 8) uint8, single (...,)
    bool, double (...,) bool)``. A single-error syndrome that names no data
    bit (a flip in the check byte) leaves the data as it is."""
    words = _words(blocks)
    syn = _syndrome72(words) ^ checks.to(torch.int64)
    single = _parity64(syn).bool()
    double = (syn != 0) & ~single
    corrected = words ^ _tables72(words.device)["flip"][syn]
    return _bytes(corrected), single, double


# ---------------------------------------------------------------------------
# parity-per-byte ("Parity Zero") baseline
# ---------------------------------------------------------------------------


def byte_parity(data: torch.Tensor) -> torch.Tensor:
    """Parity of each byte of a uint8 tensor -> uint8 0/1."""
    x = data ^ (data >> 4)
    x = x ^ (x >> 2)
    return (x ^ (x >> 1)) & 1


def encode_parity8(data: torch.Tensor) -> torch.Tensor:
    """One parity bit per byte, 8 bytes' parities packed into one check
    byte (byte j's parity is bit ``j % 8`` of check byte ``j // 8``).

    data: (..., n) uint8 with n % 8 == 0 -> (..., n // 8) uint8."""
    par = byte_parity(data).to(torch.int32)
    grouped = par.reshape(*par.shape[:-1], -1, BLOCK_BYTES)
    shifts = torch.arange(BLOCK_BYTES, dtype=torch.int32, device=data.device)
    return (grouped << shifts).sum(-1).to(torch.uint8)


def decode_parity8(data: torch.Tensor, checks: torch.Tensor):
    """Detect parity mismatches and zero the mismatching bytes (the paper's
    "zero") -> ``(data, bad (..., n) bool)``."""
    diff = (encode_parity8(data) ^ checks).to(torch.int32)   # (..., n // 8)
    shifts = torch.arange(BLOCK_BYTES, dtype=torch.int32, device=data.device)
    bad = ((diff[..., None] >> shifts) & 1).bool().reshape(data.shape)
    return torch.where(bad, torch.zeros_like(data), data), bad


def to_blocks(flat_bytes: torch.Tensor) -> torch.Tensor:
    """(n,) uint8 (n % 8 == 0) -> (n // 8, 8) uint8."""
    return flat_bytes.reshape(-1, BLOCK_BYTES)
