"""Stochastic-number (SN) arithmetic — the heart of ODIN (paper §III-C, §IV-B).

An 8-bit binary operand ``v`` (``0 <= v < n_levels``) is represented as a
``stream_len``-bit pseudorandom bitstream whose density is ``v / n_levels``:

* multiplication  = bit-parallel AND                       (paper Fig. 2a)
* scaled addition = bit-parallel MUX, ``c = s·a + s̄·b``   (paper Fig. 2b, s = 0.5)
* B→S conversion  = LUT lookup (paper's 256×256 SRAM LUT)
* S→B conversion  = popcount   (paper's PISO + level counter)

Streams are packed little-endian into 32-bit words.  torch has no uint32
arithmetic to speak of, so a word is carried as the int32 with the same bit
pattern: bitwise ops are the same, ``>>`` sign-extends and is masked after
each shift, and popcounts go through int64 (torch has no popcount either).

Stream generation is the JAX package's comparator SNG: each LUT draws one
random permutation ``perm`` of stream positions and bit ``i`` of row ``v``
is set iff ``rank(i) < v``, so row ``v`` has exactly ``v`` ones and rows are
nested.  The permutation comes from a ``torch.Generator``, which cannot
reproduce ``jax.random``'s: parity with the JAX package is held on LUTs
carried across with :func:`repro_torch.bridge.luts_from_numpy`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

WORD_BITS = 32

__all__ = [
    "StreamSpec",
    "make_lut",
    "make_select_streams",
    "b_to_s",
    "s_to_b",
    "sc_mul",
    "sc_mux",
    "sc_not",
    "sc_mac_tree",
    "sc_matmul",
    "expected_matmul",
    "int_matmul",
    "pack_bits",
    "unpack_bits",
    "popcount32",
    "tree_depth",
]


@dataclass(frozen=True)
class StreamSpec:
    """Geometry of the stochastic representation.

    ``stream_len`` — bits per stream (paper: 256 = one PCRAM row block).
    ``n_levels``   — quantization levels (paper: 256 = 8-bit operands).
    """

    stream_len: int = 256
    n_levels: int = 256

    def __post_init__(self):
        if self.stream_len % WORD_BITS:
            raise ValueError(f"stream_len must be a multiple of {WORD_BITS}")
        if self.n_levels > self.stream_len + 1:
            raise ValueError("n_levels cannot exceed stream_len + 1 (density is k/stream_len)")

    @property
    def n_words(self) -> int:
        return self.stream_len // WORD_BITS


# ---------------------------------------------------------------------------
# packing helpers
# ---------------------------------------------------------------------------

def _as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → int32 tensors with the same bit pattern."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a little-endian bool/int tensor ``[..., L]`` into int32 words
    ``[..., L/32]`` (the uint32 bit patterns)."""
    *lead, L = bits.shape
    if L % WORD_BITS:
        raise ValueError(f"bit length {L} is not a multiple of {WORD_BITS}")
    b = bits.to(torch.int64).reshape(*lead, L // WORD_BITS, WORD_BITS)
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=bits.device)
    return _as_int32_bits((b << shifts).sum(dim=-1))


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_bits` — int32 ``[..., W]`` → bool ``[..., W*32]``."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * WORD_BITS).to(torch.bool)


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int32 bit patterns) → int64, by the
    SWAR reduction in int64 so no intermediate overflows."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


# ---------------------------------------------------------------------------
# LUT construction (the paper's 256x256 SRAM block)
# ---------------------------------------------------------------------------

def make_lut(generator: torch.Generator, spec: StreamSpec = StreamSpec()) -> torch.Tensor:
    """Build one B→S lookup table: int32 ``[n_levels, n_words]`` on the
    generator's device.  Weights and activations must use LUTs drawn
    independently (a shared LUT turns AND into min)."""
    dev = generator.device
    ranks = torch.randperm(spec.stream_len, generator=generator, device=dev)
    levels = torch.arange(spec.n_levels, device=dev)[:, None]
    return pack_bits(ranks[None, :] < levels)                 # row v has v ones


def make_select_streams(generator: torch.Generator, depth: int,
                        spec: StreamSpec = StreamSpec()) -> torch.Tensor:
    """Per-tree-level ``s = 0.5`` select streams, int32 ``[depth, n_words]``,
    each with exactly ``stream_len/2`` ones."""
    dev = generator.device
    rows = [torch.randperm(spec.stream_len, generator=generator, device=dev)
            < spec.stream_len // 2 for _ in range(depth)]
    return pack_bits(torch.stack(rows))


# ---------------------------------------------------------------------------
# conversions
# ---------------------------------------------------------------------------

def b_to_s(values: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Binary → stochastic: gather LUT rows.  Values are clamped to the
    table, as the JAX gather clamps an index out of range."""
    return lut[values.long().clamp(0, lut.shape[0] - 1)]


def s_to_b(streams: torch.Tensor) -> torch.Tensor:
    """Stochastic → binary: popcount over packed words (paper's PISO+counter)."""
    return popcount32(streams).sum(dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# arithmetic (bit-parallel, over packed words)
# ---------------------------------------------------------------------------

def sc_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stochastic multiply: bitwise AND (paper Fig. 2a)."""
    return a & b


def sc_not(a: torch.Tensor) -> torch.Tensor:
    return ~a


def sc_mux(a: torch.Tensor, b: torch.Tensor, select: torch.Tensor) -> torch.Tensor:
    """Stochastic scaled add ``0.5·a + 0.5·b``: MUX = (S∧a) ∨ (S̄∧b) (Fig. 2b)."""
    return (select & a) | (~select & b)


def tree_depth(k: int) -> int:
    return max(1, int(np.ceil(np.log2(max(int(k), 2)))))


def sc_mac_tree(streams: torch.Tensor, select_streams: torch.Tensor) -> torch.Tensor:
    """Balanced MUX tree over ``streams [..., K, W]`` → one stream ``[..., W]``
    of density ``(1/K̂)·Σ densities``, K̂ = K rounded up to a power of two
    (zero-padded).  ``select_streams [depth, W]`` needs ``depth >= log2 K̂``."""
    K = streams.shape[-2]
    depth = tree_depth(K)
    pad = (1 << depth) - K
    if pad:
        zeros = streams.new_zeros((*streams.shape[:-2], pad, streams.shape[-1]))
        streams = torch.cat([streams, zeros], dim=-2)
    for level in range(depth):
        streams = sc_mux(streams[..., 0::2, :], streams[..., 1::2, :], select_streams[level])
    return streams[..., 0, :]


# ---------------------------------------------------------------------------
# full stochastic GEMM (reference semantics; the CUDA kernel fuses this)
# ---------------------------------------------------------------------------

def sc_matmul(a_q: torch.Tensor, w_q: torch.Tensor, lut_a: torch.Tensor,
              lut_w: torch.Tensor, select_streams: torch.Tensor,
              spec: StreamSpec = StreamSpec()) -> torch.Tensor:
    """ODIN MAC array in SN format.  Returns int32 popcounts ``[M, N]``:

    out[m, n] = popcount( MUXtree_k( AND(lut_a[a[m,k]], lut_w[w[k,n]]) ) )

    Materializes ``[M, N, K̂, W]`` streams — the reference semantics; the
    model path goes through ``kernels/sc_mac``.
    """
    sa = b_to_s(a_q, lut_a)                                   # [M, K, W]
    sw = b_to_s(w_q, lut_w)                                   # [K, N, W]
    prod = sc_mul(sa[:, None, :, :], sw.permute(1, 0, 2)[None])   # [M, N, K, W]
    return s_to_b(sc_mac_tree(prod, select_streams))


def int_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact integer product of small-integer operands → int32.

    The CPU multiplies in int32.  CUDA has no integer ``matmul`` (and
    ``torch._int_mm`` takes int8 only, which cannot hold a 0..255 rail), so
    the card multiplies in float64: every product and partial sum is an
    integer below 2^53, so the result is exact in any summation order.
    """
    if a.is_cuda:
        return torch.matmul(a.to(torch.float64), w.to(torch.float64)).to(torch.int32)
    return torch.matmul(a.to(torch.int32), w.to(torch.int32))


def expected_matmul(a_q: torch.Tensor, w_q: torch.Tensor,
                    spec: StreamSpec = StreamSpec()) -> torch.Tensor:
    """Deterministic expected value of :func:`sc_matmul`:
    E[popcount] = stream_len · (1/K̂) · Σ_k (a_k/L)(w_k/L), as an exact
    integer dot with the same scaling."""
    khat = 1 << tree_depth(a_q.shape[-1])
    scale = spec.stream_len / (khat * spec.n_levels * spec.n_levels)
    return int_matmul(a_q, w_q).to(torch.float32) * scale
