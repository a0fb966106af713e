"""PCRAM organization and primitive timing/energy model (paper §III-B, §VI-A).

Hierarchy (paper's example 16 GB part): 2 channels × 8 ranks × 16 banks;
each bank has 16 partitions of 4096 wordlines × 8 Kb bitlines; 256 peripheral
S/A + W/D structures ⇒ read/write granularity is one 256-bit block, and a full
8 Kb row holds 32 such blocks (= 32 packed 8-bit operands per block read,
32 stochastic operands per row).

Primitive timing is *derived from the paper's own Table 1* by solving the
linear system over the five commands:

    ANN_MUL  = 1·t_R + 1·t_W = 108 ns
    B_TO_S   = 33·t_R + 32·t_W = 3504 ns
    ⇒ t_R = 48 ns, t_W = 60 ns            (S_TO_B/ANN_POOL check: 3456 ns ✓)

Energy constants are *model inputs* (the paper extracts them from the K.-J.
Lee PRAM datasheet [29] scaled to 14 nm via [30] but does not print them);
defaults below follow that literature and are exposed for sensitivity runs.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["PCRAMGeometry", "PCRAMTiming", "PCRAMEnergy", "OdinModule"]


@dataclass(frozen=True)
class PCRAMGeometry:
    channels: int = 1            # the ODIN accelerator occupies one channel
    ranks_per_channel: int = 8
    banks_per_rank: int = 16
    partitions_per_bank: int = 16
    rows_per_partition: int = 4096
    row_bits: int = 8192         # 8 Kb row = 32 blocks
    block_bits: int = 256        # S/A + W/D granularity

    @property
    def blocks_per_row(self) -> int:
        return self.row_bits // self.block_bits          # 32

    @property
    def operands_per_block(self) -> int:
        return self.block_bits // 8                      # 32 8-bit operands

    @property
    def banks(self) -> int:
        return self.channels * self.ranks_per_channel * self.banks_per_rank  # 128

    @property
    def compute_rows_per_bank(self) -> int:
        # one whole partition per bank is the Compute Partition (paper §IV-B)
        return self.rows_per_partition

    def bank_bits(self) -> int:
        return self.partitions_per_bank * self.rows_per_partition * self.row_bits

    def module_bits(self) -> int:
        return self.banks * self.bank_bits()


@dataclass(frozen=True)
class PCRAMTiming:
    t_read_ns: float = 48.0      # per 256-bit block read  (derived from Table 1)
    t_write_ns: float = 60.0     # per 256-bit block write (derived from Table 1)


@dataclass(frozen=True)
class PCRAMEnergy:
    """Per-block (256-bit) access energies, pJ — 14 nm-scaled PCRAM literature values."""

    e_read_pj: float = 128.0     # 0.5 pJ/bit read
    e_write_pj: float = 1280.0   # 5.0 pJ/bit write (SET/RESET average)


@dataclass(frozen=True)
class OdinModule:
    """One ODIN accelerator channel: geometry + primitive costs + parallelism.

    ``partition_pairs`` — PALP-style [22] partition-level parallelism inside a
    bank: pairs of partitions can serve simultaneous row activations.  The
    paper adopts PALP for its conv mapping (its VGG conv read counts imply a
    combined row-packing × partition factor of ≈256; see trace.py).
    """

    geom: PCRAMGeometry = PCRAMGeometry()
    timing: PCRAMTiming = PCRAMTiming()
    energy: PCRAMEnergy = PCRAMEnergy()
    partition_pairs: int = 8     # concurrent row-pair activations per bank

    @property
    def parallel_units(self) -> int:
        """Independent command streams across the module (banks × partition pairs)."""
        return self.geom.banks * self.partition_pairs
