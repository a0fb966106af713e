"""The five ODIN PIM-controller (PIMC) commands — paper §IV-C, Table 1.

Each command is a fixed activity flow of PCRAM block READs/WRITEs plus add-on
logic work.  Latency is ``reads·t_R + writes·t_W``; with the paper-derived
(t_R, t_W) = (48, 60) ns this reproduces Table 1 *exactly* (asserted in
tests/benchmarks).  Energy adds the add-on logic components of Table 3.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.pim.geometry import OdinModule

__all__ = ["AddOnEnergy", "Command", "command_set", "TABLE1_EXPECTED"]


# Table 3 (paper, 14 nm CMOS) — per-use energies of add-on circuits, pJ.
TABLE3_PJ = {
    "sram_lut": 0.297,
    "mux_16_8": 4.662,
    "mux_256_8": 4.72,
    "mux_256_32": 18.6,
    "demux_8_32": 18.64,
    "demux_8_256": 149.19,
    "demux_256_1024": 902.8,
    "relu": 185.0,
    "pool": 2140.0,
}

# Table 1 (paper) — ground truth used by tests.
TABLE1_EXPECTED = {
    "B_TO_S": dict(reads=33, writes=32, latency_ns=3504),
    "S_TO_B": dict(reads=32, writes=32, latency_ns=3456),
    "ANN_POOL": dict(reads=32, writes=32, latency_ns=3456),
    "ANN_MUL": dict(reads=1, writes=1, latency_ns=108),
    "ANN_ACC": dict(reads=1, writes=1, latency_ns=108),
}


@dataclass(frozen=True)
class AddOnEnergy:
    """Add-on logic energy per command invocation, composed from Table 3."""

    pj: float


@dataclass(frozen=True)
class Command:
    name: str
    reads: int               # 256-bit PCRAM block reads per invocation
    writes: int              # 256-bit PCRAM block writes per invocation
    addon_pj: float          # CMOS add-on energy per invocation

    def latency_ns(self, m: OdinModule) -> float:
        return self.reads * m.timing.t_read_ns + self.writes * m.timing.t_write_ns

    def energy_pj(self, m: OdinModule) -> float:
        return (
            self.reads * m.energy.e_read_pj
            + self.writes * m.energy.e_write_pj
            + self.addon_pj
        )


def command_set() -> Dict[str, Command]:
    """Activity flows per paper Fig. 5, add-on energy compositions per §IV-B.

    * B_TO_S  — 1 operand-block read + 32 stream-row writes (+32 LUT-iteration
      reads per Table 1's 33): per operand an SRAM-LUT access and an 8:256
      demux into the stream row.
    * S_TO_B  — 32 stream reads; per operand a 256:8 mux (popcount readout
      path) and the 8-bit ReLU block; 32 writes assemble results (Fig. 5d).
    * ANN_POOL— 32 reads / 32 writes; 4:1 pooling block per group of four
      operands (32/4 = 8 uses) plus a 256:32 mux staging.
    * ANN_MUL — one PINATUBO double-row activation read (bit-parallel AND) +
      one result-row write.  Sense-amp modification energy is folded into the
      block read energy (as in PINATUBO [3]).
    * ANN_ACC — one MUX step = AND/AND/OR over pre-stored S, S' rows; the
      paper's Table 1 counts it as 1R + 1W (the three logical ops share one
      multi-row activation), which we follow.
    """
    ops = 32  # operands per command invocation
    return {
        "B_TO_S": Command(
            "B_TO_S", 33, 32, ops * (TABLE3_PJ["sram_lut"] + TABLE3_PJ["demux_8_256"])
        ),
        "S_TO_B": Command(
            "S_TO_B", 32, 32, ops * (TABLE3_PJ["mux_256_8"] + TABLE3_PJ["relu"])
        ),
        "ANN_POOL": Command(
            "ANN_POOL", 32, 32, (ops // 4) * TABLE3_PJ["pool"] + TABLE3_PJ["mux_256_32"]
        ),
        "ANN_MUL": Command("ANN_MUL", 1, 1, 0.0),
        "ANN_ACC": Command("ANN_ACC", 1, 1, 0.0),
        # Fused conv variant: the AND result stays latched in the sense amps
        # and feeds the subsequent ANN_ACC directly (PINATUBO cascading) —
        # 1 read, 0 writes.  Not a PIMC command of its own (Table 1 lists
        # five); it is ANN_MUL issued with write-back suppressed, which is
        # the accounting the paper's own Table 2 conv read:write = 2:1
        # ratio implies.
        "ANN_MUL_F": Command("ANN_MUL_F", 1, 0, 0.0),
    }
