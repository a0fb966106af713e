"""ODIN execution modes for a linear layer — the paper's technique as a drop-in.

Three modes, sharing one quantization boundary:

``exact``  — plain matmul, the reference numerics.
``int8``   — the deterministic *expected value* of the stochastic pipeline:
             8-bit rails, an exact integer dot, the same 1/K̂ MUX-tree
             scaling and optional 8-bit popcount rounding.
``sc``     — bit-faithful stochastic arithmetic: B→S LUTs, bit-parallel AND,
             MUX tree, popcount (paper §IV), through ``kernels/sc_mac``.

Signed operands use the two-rail decomposition with binary-domain
recombination (``core/quant.py``).  The modes follow the JAX package's
``use_pallas=False`` path, which is what its model paths run; the tensor's
device chooses between the CUDA kernel and the plain version.  A full tree
stays one tree at any K̂ (the JAX ``use_pallas=True`` wrapper would tile it
at 2048).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import stochastic as sc
from repro_torch.core.quant import quantize_signed_tworail, quantize_unipolar
# the module, not its function: sc_mac's ops import this package's
# stochastic core, so either side may be imported first
from repro_torch.kernels.sc_mac import ops as sc_mac_ops
from repro_torch.kernels.sc_mac.ref import tile_k

__all__ = ["OdinConfig", "odin_linear", "get_luts"]


@dataclass(frozen=True)
class OdinConfig:
    mode: str = "exact"                   # exact | int8 | sc
    stream_len: int = 256
    n_levels: int = 256
    signed_activations: bool = True       # False after ReLU (paper's CNN case)
    round_popcount: bool = False          # model 8-bit S_TO_B output rounding
    lut_seed: int = 0
    # SC accumulation granularity.  0 ⇒ one full MUX tree over K (at
    # K ≳ stream_len the 1/K̂ subsampling leaves < 1 stream bit per product
    # and the signal collapses).  > 0 ⇒ per-block MUX subtree + popcount +
    # binary accumulation across blocks — ODIN's own 32-operand row/command
    # granularity.
    sc_block_k: int = 32
    # PCRAM resistance-drift analog: > 0 perturbs the SC/int8 output
    # multiplicatively with seeded Gaussian noise of this relative σ.
    # ``exact`` mode is never perturbed.
    drift_noise: float = 0.0
    drift_seed: int = 0

    @property
    def spec(self) -> sc.StreamSpec:
        return sc.StreamSpec(self.stream_len, self.n_levels)


@functools.lru_cache(maxsize=16)
def get_luts(stream_len: int, n_levels: int, lut_seed: int, max_depth: int = 20,
             device="cpu"):
    """Deterministic LUT/select-stream constants (the per-bank SRAM
    contents) on ``device``: ``(lut_a, lut_w, selects)``, drawn on the CPU
    from one seeded generator so every device sees the same tables."""
    spec = sc.StreamSpec(stream_len, n_levels)
    g = torch.Generator().manual_seed(lut_seed)
    luts = (sc.make_lut(g, spec), sc.make_lut(g, spec), sc.make_select_streams(g, max_depth, spec))
    return tuple(t.to(device) for t in luts)


def _rail_matmul(a_q, w_q, cfg: OdinConfig, luts=None) -> torch.Tensor:
    """One unipolar rail-pair product in integer-dot units (Σ a·w)."""
    spec = cfg.spec
    khat = 1 << sc.tree_depth(a_q.shape[-1])
    if cfg.mode == "sc":
        lut_a, lut_w, selects = luts
        # trees of bk leaves: one full tree over K̂, or the hybrid regime's
        # per-block subtrees whose popcounts accumulate in binary
        bk = tile_k(a_q.shape[-1], cfg.sc_block_k)
        pop = sc_mac_ops.sc_mac_popcounts(a_q, w_q, lut_a, lut_w, selects, spec, bk)
        # popcount → integer-dot units: Σ a·w ≈ pop · bk L² / stream_len
        return pop.to(torch.float32) * (bk * spec.n_levels**2 / spec.stream_len)
    # int8 expected surrogate — identical scaling; optionally round to the
    # 8-bit popcount grid to model S_TO_B precision loss.
    dot = sc.int_matmul(a_q, w_q)
    if cfg.round_popcount:
        pop_scale = spec.stream_len / (khat * spec.n_levels**2)
        pop = torch.round(dot.to(torch.float32) * pop_scale)
        return pop * (khat * spec.n_levels**2 / spec.stream_len)
    return dot.to(torch.float32)


def _drift_generator(cfg: OdinConfig, drift_step: int, device) -> torch.Generator:
    seed = int(np.random.SeedSequence([cfg.drift_seed, int(drift_step)]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def odin_linear(x: torch.Tensor, w: torch.Tensor, cfg: OdinConfig = OdinConfig(),
                drift_step: int = 0, luts=None) -> torch.Tensor:
    """``x @ w`` under the configured ODIN execution mode.

    x: [..., K] activations; w: [K, N] weights.  Returns float32 [..., N].
    ``luts`` overrides the ``(lut_a, lut_w, selects)`` of
    :func:`get_luts` (tests pass the JAX package's tables).  ``drift_step``
    keys the drift-noise pattern in time: each step draws a fresh one.
    """
    if cfg.mode == "exact":
        return torch.matmul(x, w)
    if cfg.mode not in ("int8", "sc"):
        raise ValueError(f"unknown ODIN mode: {cfg.mode}")

    lead = x.shape[:-1]
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    if cfg.mode == "sc" and luts is None:
        luts = get_luts(cfg.stream_len, cfg.n_levels, cfg.lut_seed, device=x.device)
    w_pos, w_neg, wq = quantize_signed_tworail(w)
    if cfg.signed_activations:
        a_pos, a_neg, aq = quantize_signed_tworail(x2)
        # (A⁺−A⁻)(W⁺−W⁻) — four unipolar trees, recombined in binary domain.
        out = (
            _rail_matmul(a_pos, w_pos, cfg, luts)
            + _rail_matmul(a_neg, w_neg, cfg, luts)
            - _rail_matmul(a_pos, w_neg, cfg, luts)
            - _rail_matmul(a_neg, w_pos, cfg, luts)
        )
    else:
        a_q, aq = quantize_unipolar(x2)
        out = _rail_matmul(a_q, w_pos, cfg, luts) - _rail_matmul(a_q, w_neg, cfg, luts)

    y = out * (aq.scale * wq.scale)
    if cfg.drift_noise > 0.0:
        g = _drift_generator(cfg, drift_step, y.device)
        noise = torch.randn(y.shape, generator=g, dtype=torch.float32, device=y.device)
        y = y * (1.0 + cfg.drift_noise * noise)
    return y.reshape(*lead, w.shape[-1]).to(torch.float32)
