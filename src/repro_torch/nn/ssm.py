"""Selective state-space (Mamba-style) block — Hymba's SSM heads.

The port of the JAX package's ``nn/ssm.py``.  Recurrence (per channel c,
state n):

    h_t = exp(Δ_t · A) ⊙ h_{t-1} + Δ_t · B_t · x_t
    y_t = C_t · h_t + D ⊙ x_t

with input-dependent Δ, B, C.  The state ``h [B, d_inner, N]`` and the
scan run in float32 with the JAX package's cast points: the x-projection,
Δ, the scan input and the stored conv context are float32, ``y`` is cast
back to the activation dtype before the gate.  The scan is a plain time
loop (:func:`repro_torch.nn.scan_utils.chunked_scan`): about six eager
operations a token, as the JAX package runs jnp there.  The carry is pinned
to batch × mlp sharding as in the reference (``nn.pcontext.constrain``, the
identity outside a ``logical_sharding`` context and on plain tensors); on
DTensors each rank scans its own (batch, channel) block.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.core.odin_linear import OdinConfig
from repro_torch.nn.layers import linear, linear_spec
from repro_torch.nn.module import ParamSpec
from repro_torch.nn.pcontext import block_placements, constrain, from_block, is_dtensor, to_block
from repro_torch.nn.scan_utils import chunked_scan

__all__ = ["ssm_spec", "ssm_block", "init_ssm_state"]


def _dt_rank(cfg: SSMConfig, d_model: int) -> int:
    return cfg.dt_rank or max(1, d_model // 16)


def ssm_spec(cfg: SSMConfig, d_model: int) -> Dict[str, ParamSpec]:
    d_inner = cfg.expand * d_model
    dt_rank = _dt_rank(cfg, d_model)
    N = cfg.state_dim
    return {
        "in_proj": linear_spec(d_model, 2 * d_inner, ("embed", "mlp")),
        "conv_w": ParamSpec((cfg.conv_dim, d_inner), (None, "mlp"), init="fan_in"),
        "x_proj": linear_spec(d_inner, dt_rank + 2 * N, ("mlp", None)),
        "dt_proj": ParamSpec((dt_rank, d_inner), (None, "mlp"), init="fan_in"),
        "dt_bias": ParamSpec((d_inner,), ("mlp",), torch.float32, init="zeros"),
        "A_log": ParamSpec((d_inner, N), ("mlp", None), torch.float32, init="zeros"),
        "D": ParamSpec((d_inner,), ("mlp",), torch.float32, init="ones"),
        "out_proj": linear_spec(d_inner, d_model, ("mlp", "embed")),
    }


def init_ssm_state(cfg: SSMConfig, d_model: int, batch: int, dtype=torch.float32,
                   device=None):
    d_inner = cfg.expand * d_model
    return {
        "h": torch.zeros((batch, d_inner, cfg.state_dim), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.conv_dim - 1, d_inner), dtype=dtype,
                            device=device),
    }


def _selective_scan(u, dt, A, Bc, Cc, D, h0):
    """u: [B,S,di]  dt: [B,S,di]  A: [di,N]  Bc/Cc: [B,S,N]  h0: [B,di,N]
    → (y [B,S,di], h [B,di,N]).  The [B,S,di,N] discretised tensors are
    never materialised: each step forms its own outer products."""

    def step(h, inp):
        u_t, dt_t, b_t, c_t = inp                       # [B,di],[B,di],[B,N],[B,N]
        dA_t = torch.exp(dt_t[..., None] * A[None])     # [B,di,N]
        h = dA_t * h + (dt_t * u_t)[..., None] * b_t[:, None, :]
        y = torch.einsum("bdn,bn->bd", h, c_t)
        return h, y

    h, ys = chunked_scan(step, h0, [t.transpose(0, 1) for t in (u, dt, Bc, Cc)])
    y = ys.transpose(0, 1) + u * D[None, None]
    return y, h


def _sharded_scan(x, u, dt, A, Bc, Cc, D, h0):
    """``_selective_scan`` of DTensors, each rank on its own (batch,
    channel) block: the recurrence is local in both, so no collective runs
    inside it (``x`` is the block's input, whose batch sharding the blocks
    keep)."""
    mesh, di = x.device_mesh, u.shape[-1]
    pl_seq, pl_h = block_placements(x, di, 2), block_placements(x, di, 1)
    pl_bc = block_placements(x, di, None)
    pl_ch = block_placements(x, di, 0, batch=False)
    y, h = _selective_scan(to_block(u, mesh, pl_seq), to_block(dt, mesh, pl_seq),
                           to_block(A, mesh, pl_ch, pl_seq), to_block(Bc, mesh, pl_bc, pl_seq),
                           to_block(Cc, mesh, pl_bc, pl_seq), to_block(D, mesh, pl_ch, pl_seq),
                           to_block(h0, mesh, pl_h))
    return from_block(y, mesh, pl_seq, u.shape), from_block(h, mesh, pl_h, h0.shape)


def ssm_block(p, x: torch.Tensor, cfg: SSMConfig, state=None,
              odin: Optional[OdinConfig] = None):
    """x: [B,S,d] → (y [B,S,d], new_state).  ``state`` (``h``, ``conv``)
    enables decode; the new state is new tensors, never the old ones
    updated in place."""
    B, S, d = x.shape
    d_inner = cfg.expand * d
    N = cfg.state_dim
    dt_rank = _dt_rank(cfg, d)

    xz = linear(x, p["in_proj"], odin)
    u, z = torch.chunk(xz, 2, dim=-1)                   # [B,S,di] each

    # depthwise causal conv over time
    K = cfg.conv_dim
    if state is not None:
        ctx = torch.cat([state["conv"].to(u.dtype), u], dim=1)
    else:
        ctx = F.pad(u, (0, 0, K - 1, 0))
    windows = torch.stack([ctx[:, i:i + S] for i in range(K)], dim=-1)   # [B,S,di,K]
    u = F.silu(torch.einsum("bsdk,kd->bsd", windows, p["conv_w"].to(u.dtype)))

    proj = linear(u, p["x_proj"], odin).float()
    dt_in, Bc, Cc = torch.split(proj, [dt_rank, N, N], dim=-1)
    dt = F.softplus(dt_in @ p["dt_proj"].float() + p["dt_bias"])       # [B,S,di]
    A = -torch.exp(p["A_log"])                                         # [di,N]

    h0 = (state["h"] if state is not None
          else torch.zeros((B, d_inner, N), dtype=torch.float32, device=x.device))
    h0 = constrain(h0, ("batch", "mlp", None))   # pin batch/TP sharding of the carry
    if is_dtensor(x):
        y, h = _sharded_scan(x, u.float(), dt, A, Bc, Cc, p["D"], h0)
    else:
        y, h = _selective_scan(u.float(), dt, A, Bc, Cc, p["D"], h0)
    y = y.to(x.dtype) * F.silu(z)
    out = linear(y, p["out_proj"], odin)
    new_state = None
    if state is not None:
        new_state = {"h": h, "conv": ctx[:, -(K - 1):].float()}
    return out, new_state
