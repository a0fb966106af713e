"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM (scalar).

The port of the JAX package's ``nn/xlstm.py``.  mLSTM keeps a matrix memory
``C [B, H, dk, dv]`` with exponential input/forget gates and a max-state
stabiliser; sLSTM keeps a per-channel scalar state with a diagonal
recurrence on ``h``.  Both expose single-step decode through their state.

Numerics follow the reference: q, k/√dh, v, the gates and every state are
float32 whatever the activation dtype (an int8 ``kv_dtype`` never reaches
them), ``h`` is cast to the activation dtype before the output gate, and
sLSTM's ``r_zifo`` is a float32 leaf.  ``log σ(f)`` is
:func:`torch.nn.functional.logsigmoid`, the reference's ``-softplus(-f)``
within float32 rounding (``tests/test_torch_xlstm.py`` holds the two
together, the padded gate ``f = 30`` included).

The token scans are :func:`repro_torch.nn.scan_utils.chunked_scan` (a plain
time loop in the reference's chunk order); the chunkwise mLSTM form loops
over chunks and runs each chunk's masked decay matrices as batched
matmuls.  The reference's sharding hint on the carry is kept
(``nn.pcontext.constrain``: the state's batch axis), the identity outside a
``logical_sharding`` context and on plain tensors.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.odin_linear import OdinConfig
from repro_torch.nn.layers import linear, linear_spec, norm_spec, rmsnorm
from repro_torch.nn.module import ParamSpec
from repro_torch.nn.pcontext import (active, block_placements, constrain, from_block,
                                     is_dtensor, reshape, to_block)
from repro_torch.nn.scan_utils import chunked_scan

__all__ = ["mlstm_spec", "mlstm_block", "slstm_spec", "slstm_block", "init_mlstm_state",
           "init_slstm_state"]


def mlstm_spec(n_heads: int, d_model: int) -> Dict[str, ParamSpec]:
    return {
        "q": linear_spec(d_model, d_model, ("embed", "heads_flat")),
        "k": linear_spec(d_model, d_model, ("embed", "heads_flat")),
        "v": linear_spec(d_model, d_model, ("embed", "heads_flat")),
        "gates": linear_spec(d_model, 2 * n_heads, ("embed", None)),  # i, f per head
        "o_gate": linear_spec(d_model, d_model, ("embed", "heads_flat")),
        "out": linear_spec(d_model, d_model, ("heads_flat", "embed")),
        "out_norm": norm_spec(d_model),
    }


def init_mlstm_state(n_heads: int, d_model: int, batch: int, device=None):
    dh = d_model // n_heads
    return {
        "C": torch.zeros((batch, n_heads, dh, dh), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, n_heads, dh), dtype=torch.float32, device=device),
        "m": torch.full((batch, n_heads), -1e30, dtype=torch.float32, device=device),
    }


def mlstm_block(p, x: torch.Tensor, n_heads: int, state=None,
                odin: Optional[OdinConfig] = None, impl: str = "chunkwise",
                chunk: int = 512):
    """x: [B,S,d] → (out [B,S,d], new_state or None).  ``impl``: 'scan'
    (token-sequential) or 'chunkwise' (the telescoped per-chunk form, run
    when S > 1; the same math in another summation order).  On a DTensor
    ``x`` each rank runs the recurrence on its own (batch, head) block."""
    B, S, d = x.shape
    dh = d // n_heads
    q = reshape(linear(x, p["q"], odin), B, S, n_heads, dh).float()
    k = reshape(linear(x, p["k"], odin), B, S, n_heads, dh).float() / math.sqrt(dh)
    v = reshape(linear(x, p["v"], odin), B, S, n_heads, dh).float()
    gates = reshape(linear(x, p["gates"], odin).float(), B, S, n_heads, 2)
    i_pre, f_pre = gates[..., 0], gates[..., 1]                  # [B,S,H]
    o_gate = torch.sigmoid(linear(x, p["o_gate"], odin).float())

    st = state
    if st is not None and active():      # pin batch sharding of the matrix-memory carry
        st = {k: constrain(v, ("batch",) + (None,) * (v.dim() - 1)) for k, v in st.items()}
    if is_dtensor(x):
        mesh = x.device_mesh
        pl_seq, pl_st = block_placements(x, n_heads, 2), block_placements(x, n_heads, 1)
        ql, kl, vl, il, fl = (to_block(t, mesh, pl_seq) for t in (q, k, v, i_pre, f_pre))
        st_l = (init_mlstm_state(ql.shape[2], ql.shape[2] * dh, ql.shape[0], ql.device)
                if st is None else {k: to_block(v, mesh, pl_st) for k, v in st.items()})
        (C, n, m), ys = _mlstm_core(ql, kl, vl, il, fl, st_l, impl, chunk)
        ys = from_block(ys, mesh, pl_seq, (B, S, n_heads, dh))
        C, n, m = (from_block(a, mesh, pl_st, (B, n_heads, *a.shape[2:]))
                   for a in (C, n, m))
    else:
        if st is None:
            st = init_mlstm_state(n_heads, d, B, x.device)
        (C, n, m), ys = _mlstm_core(q, k, v, i_pre, f_pre, st, impl, chunk)
    h = reshape(ys, B, S, d).to(x.dtype) * o_gate.to(x.dtype)
    out = linear(rmsnorm(h, p["out_norm"]), p["out"], odin)
    new_state = {"C": C, "n": n, "m": m} if state is not None else None
    return out, new_state


def _mlstm_core(q, k, v, i_pre, f_pre, st, impl: str, chunk: int):
    """The mLSTM recurrence over the sequence: ((C, n, m), h [B,S,H,dh]),
    the chunkwise form when S > 1 and ``impl`` asks for it, else the token
    scan."""
    if impl == "chunkwise" and q.shape[1] > 1:
        return _mlstm_chunkwise(q, k, v, i_pre, f_pre, (st["C"], st["n"], st["m"]), chunk)

    def step(carry, inp):
        C, n, m = carry
        qt, kt, vt, it, ft = inp                             # [B,H,dh], [B,H]
        log_f = F.logsigmoid(ft)                             # log σ(f)
        m_new = torch.maximum(log_f + m, it)
        i_sc = torch.exp(it - m_new)
        f_sc = torch.exp(log_f + m - m_new)
        C = (f_sc[..., None, None] * C
             + i_sc[..., None, None] * (kt[..., :, None] * vt[..., None, :]))
        n = f_sc[..., None] * n + i_sc[..., None] * kt
        num = torch.einsum("bhkv,bhk->bhv", C, qt)
        den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n, qt)),
                            torch.exp(-m_new))
        return (C, n, m_new), num / den[..., None]

    carry, ys = chunked_scan(step, (st["C"], st["n"], st["m"]),
                             [t.transpose(0, 1) for t in (q, k, v, i_pre, f_pre)], chunk=256)
    return carry, ys.transpose(0, 1)


def _mlstm_chunkwise(q, k, v, i_pre, f_pre, st0, chunk: int):
    """Chunkwise-parallel mLSTM: the exact telescoping of the per-token
    recurrence with max-stabiliser chaining.  Within a chunk, relative to
    the chunk-entry state (C₀, n₀, m₀) and the in-chunk cumulative
    log-forget B_t = Σ_{s≤t} log f_s:

        m_t  = max(B_t + m₀, max_{s≤t}(B_t − B_s + i_s))
        h_t ∝ e^{B_t+m₀−m_t}(q_t·C₀) + Σ_{s≤t} e^{B_t−B_s+i_s−m_t}(q_t·k_s)v_s
        n_t  = e^{B_t+m₀−m_t} n₀ + Σ_{s≤t} e^{B_t−B_s+i_s−m_t} k_s

    S is padded to a multiple of the chunk with ``i = -1e30`` (no input)
    and ``f = 30`` (log σ ≈ -1e-13, no decay), so pad rows leave the carry
    as the last real row left it; their outputs are dropped.  The causal
    mask is ``-inf``: every row keeps ``s = t``, so ``m_t`` is finite."""
    B, S, H, dh = q.shape
    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        i_pre = F.pad(i_pre, (0, 0, 0, pad), value=-1e30)
        f_pre = F.pad(f_pre, (0, 0, 0, pad), value=30.0)
    nc = (S + pad) // c
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))[None, :, :, None]

    C0, n0, m0 = st0                     # [B,H,dh,dh], [B,H,dh], [B,H]
    ys = []
    for j in range(nc):
        sl = slice(j * c, (j + 1) * c)
        qt, kt, vt, it, ft = q[:, sl], k[:, sl], v[:, sl], i_pre[:, sl], f_pre[:, sl]
        log_f = F.logsigmoid(ft)                                    # [B,c,H]
        Bc = torch.cumsum(log_f, dim=1)                             # B_t
        # a[t,s] = B_t − B_s + i_s  (valid s ≤ t)
        a = Bc[:, :, None] - Bc[:, None, :] + it[:, None, :]        # [B,t,s,H]
        a = torch.where(mask, a, -math.inf)
        m_intra = a.amax(dim=2)                                     # [B,c,H]
        m_t = torch.maximum(Bc + m0[:, None], m_intra)
        D = torch.exp(a - m_t[:, :, None])                          # decay matrices
        inter_w = torch.exp(Bc + m0[:, None] - m_t)                 # [B,c,H]
        scores = torch.einsum("bthd,bshd->btsh", qt, kt) * D
        y_intra = torch.einsum("btsh,bshd->bthd", scores, vt)
        n_intra = torch.einsum("btsh,bshd->bthd", D, kt)
        y_inter = torch.einsum("bthd,bhde->bthe", qt, C0) * inter_w[..., None]
        n_inter = n0[:, None] * inter_w[..., None]
        num = y_intra + y_inter                                     # [B,c,H,dv]
        nvec = n_intra + n_inter
        den = torch.maximum(torch.abs(torch.einsum("bthd,bthd->bth", qt, nvec)),
                            torch.exp(-m_t))
        ys.append(num / den[..., None])
        # carry to the next chunk (the chunk's last row)
        m_new = m_t[:, -1]
        w_end = torch.exp(Bc[:, -1:, :] - Bc + it - m_new[:, None])  # [B,s,H]
        decay = torch.exp(Bc[:, -1] + m0 - m_new)
        C0 = (C0 * decay[..., None, None]
              + torch.einsum("bshd,bshe->bhde", w_end[..., None] * kt, vt))
        n0 = n0 * decay[..., None] + torch.einsum("bsh,bshd->bhd", w_end, kt)
        m0 = m_new
    ys = torch.cat(ys, dim=1)[:, :S]
    return (C0, n0, m0), ys


def slstm_spec(n_heads: int, d_model: int) -> Dict[str, ParamSpec]:
    return {
        "zifo": linear_spec(d_model, 4 * d_model, ("embed", "heads_flat")),
        "r_zifo": ParamSpec((4, d_model), (None, "heads_flat"), torch.float32,
                            init="fan_in"),
        "out": linear_spec(d_model, d_model, ("heads_flat", "embed")),
        "out_norm": norm_spec(d_model),
    }


def init_slstm_state(d_model: int, batch: int, device=None):
    def full(value):
        return torch.full((batch, d_model), value, dtype=torch.float32, device=device)

    return {"c": full(0.0), "n": full(1.0), "h": full(0.0), "m": full(0.0)}


def slstm_block(p, x: torch.Tensor, state=None, odin: Optional[OdinConfig] = None):
    """Scalar-memory LSTM with exponential gating and a diagonal recurrent
    h-feedback.  x: [B,S,d] → (out [B,S,d], new_state or None).  On a
    DTensor ``x`` each rank runs the recurrence on its own (batch, channel)
    block."""
    B, S, d = x.shape
    pre = reshape(linear(x, p["zifo"], odin).float(), B, S, 4, d)
    st = state
    if st is not None and active():
        st = {k: constrain(v, ("batch",) + (None,) * (v.dim() - 1)) for k, v in st.items()}
    if is_dtensor(x):
        mesh = x.device_mesh
        pl_pre, pl_st = block_placements(x, d, 3), block_placements(x, d, 1)
        pre_l = to_block(pre, mesh, pl_pre)
        r = to_block(p["r_zifo"], mesh, block_placements(x, d, 1, batch=False), pl_pre)
        st_l = (init_slstm_state(pre_l.shape[3], pre_l.shape[0], pre_l.device) if st is None
                else {k: to_block(v, mesh, pl_st) for k, v in st.items()})
        (c, n, h, m), y = _slstm_core(pre_l, r, st_l)
        y = from_block(y, mesh, block_placements(x, d, 2), (B, S, d))
        c, n, h, m = (from_block(a, mesh, pl_st, (B, d)) for a in (c, n, h, m))
    else:
        if st is None:
            st = init_slstm_state(d, B, x.device)
        (c, n, h, m), y = _slstm_core(pre, p["r_zifo"], st)
    out = linear(rmsnorm(y.to(x.dtype), p["out_norm"]), p["out"], odin)
    new_state = {"c": c, "n": n, "h": h, "m": m} if state is not None else None
    return out, new_state


def _slstm_core(pre, r, st):
    """The sLSTM recurrence over ``pre [B,S,4,d]`` with ``r [4, d]``:
    ((c, n, h, m), y [B,S,d])."""

    def step(carry, inp):
        c, n, h, m = carry
        zifo_t = inp[0] + r * h[:, None]         # each gate's z/i/f/o_t + r·h
        zt = torch.tanh(zifo_t[:, 0])
        it, ft = zifo_t[:, 1], zifo_t[:, 2]
        ot = torch.sigmoid(zifo_t[:, 3])
        log_f = F.logsigmoid(ft)
        m_new = torch.maximum(log_f + m, it)
        i_sc = torch.exp(it - m_new)
        f_sc = torch.exp(log_f + m - m_new)
        c = f_sc * c + i_sc * zt
        n = f_sc * n + i_sc
        h_new = ot * c / torch.clamp_min(n, 1e-6)
        return (c, n, h_new, m_new), h_new

    carry, ys = chunked_scan(step, (st["c"], st["n"], st["h"], st["m"]),
                             [pre.transpose(0, 1)], chunk=256)
    return carry, ys.transpose(0, 1)
