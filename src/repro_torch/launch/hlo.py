"""Step analysis: FLOPs, memory traffic, collectives and the roofline, the
port's counterpart of the JAX package's ``launch/hlo.py``.

The reference parses the optimized HLO text of a compiled step.  The port
has no HLO: eager PyTorch runs every op as it is dispatched, so
:class:`CostCounter` counts what a step really dispatches, one rank's view:

* **dot FLOPs** — ``2 · numel(out) · K`` for ``mm``, ``addmm``, ``bmm``,
  ``baddbmm`` (``matmul`` and ``einsum`` reach the dispatcher as these) and
  the fused attention ops; elementwise FLOPs are ignored, as in the
  reference.
* **memory traffic** — Σ operand bytes + result bytes of every op that is
  not a view: eager mode fuses nothing, so each op reads its inputs and
  writes its outputs.
* **collective bytes** — the payload (operand bytes) of every collective,
  by type, under the reference's names, and by the innermost
  ``nn.pcontext.collective_scope`` it ran in (the layers name theirs:
  ``weights``, ``attention partials``, ``moe dispatch``).
* **op count** — the ops that move bytes (views, allocations and detaches
  excluded): on the card, the kernels the step launches, collectives aside.
* **live memory** — the peak of the bytes held by storages the step
  allocated (its temporaries and outputs).

Under DTensor the counter declines the DTensor-level op and counts the ops
DTensor runs on each rank's local shards (not the fake-tensor runs of its
shape propagation), so every number is per rank, as
the reference's partitioned module is per device.  A Python loop over
layers is counted as it runs: no trip count is needed.  The counter runs on
meta tensors (the dry-run) as on real ones.

Hardware model: one NVIDIA H100 SXM (data sheet): 989 TFLOP/s dense bf16,
3.35 TB/s HBM3, 450 GB/s NVLink a direction, 80 GB.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.nn.pcontext import current_scope

__all__ = ["HW", "CostCounter", "ModuleCosts", "collective_bytes", "roofline_terms",
           "parse_dtype_bytes"]


@dataclass(frozen=True)
class HW:
    peak_flops: float = 989e12         # dense bf16 FLOP/s per card
    hbm_bw: float = 3.35e12            # bytes/s per card
    ici_bw: float = 450e9              # NVLink bytes/s per card, one direction
    hbm_bytes: float = 80e9            # capacity


_COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# dispatcher op name → the reference's collective type
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}

_DOTS = {"mm", "addmm", "bmm", "baddbmm"}
_SDPA = {"_scaled_dot_product_flash_attention", "_scaled_dot_product_efficient_attention",
         "_scaled_dot_product_cudnn_attention", "_scaled_dot_product_attention_math",
         "_scaled_dot_product_flash_attention_for_cpu"}
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
               "wait_tensor", "_local_scalar_dense", "detach", "lift_fresh",
               "set_", "resize_", "record_stream"}


def parse_dtype_bytes(dtype) -> Optional[int]:
    """Bytes per element of a torch dtype (or its name: ``"bfloat16"``)."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype, None)
        if not isinstance(dtype, torch.dtype):
            return None
    return torch.empty((), dtype=dtype).element_size()


@dataclass
class ModuleCosts:
    flops: float = 0.0
    memory_bytes: float = 0.0
    collectives: Dict[str, float] = field(
        default_factory=lambda: {c: 0.0 for c in _COLLECTIVES})
    collective_total: float = 0.0
    collective_wire: float = 0.0
    n_ops: int = 0
    n_collectives: int = 0
    peak_live_bytes: float = 0.0
    n_whiles: int = 0              # the reference's keys: no loop is opaque here
    n_unknown_trip: int = 0
    # collective payloads by ``nn.pcontext.collective_scope`` name and type
    collectives_by_scope: Dict[str, Dict[str, float]] = field(default_factory=dict)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dot_flops(name: str, args, out) -> float:
    a = args[1] if name in ("addmm", "baddbmm") else args[0]
    return 2.0 * out.numel() * a.shape[-1]


def _sdpa_flops(args) -> float:
    q, k, v = args[0], args[1], args[2]           # [B, H, Sq, D], [B, H, Sk, D], [.., Dv]
    lead = q.numel() // (q.shape[-2] * q.shape[-1])
    return 2.0 * lead * q.shape[-2] * k.shape[-2] * (q.shape[-1] + v.shape[-1])


class CostCounter(TorchDispatchMode):
    """Counts one rank's FLOPs, bytes, collectives and live memory of
    everything dispatched inside it (see the module docstring).  Read
    ``costs()`` after the block."""

    def __init__(self):
        super().__init__()
        self.c = ModuleCosts()
        self._live = 0
        self._seen = set()

    def exclude(self, tree):
        """Count the storages of ``tree``'s tensors (a step's inputs; a
        DTensor's local shard) as held before the step: views and in-place
        updates of them allocate nothing."""
        for t in _tensors(tree):
            t = t.to_local() if hasattr(t, "to_local") else t
            self._seen.add(t.untyped_storage()._cdata)

    def _release(self, key, n):
        self._seen.discard(key)
        self._live -= n

    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen.add(key)
        self._live += n
        self.c.peak_live_bytes = max(self.c.peak_live_bytes, self._live)
        weakref.finalize(st, self._release, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # let DTensor run; count its local ops
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in _tensors((args, kwargs, out))):
            # DTensor's shape propagation, not the step (its fake global
            # tensors, made by ops with no tensor argument, too)
            return out
        name = func._schema.name.split("::")[-1]
        coll = _COLLECTIVE_OPS.get(name)
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        if coll is not None:
            payload = sum(_nbytes(t) for t in ins)
            self.c.collectives[coll] += payload
            scope = self.c.collectives_by_scope.setdefault(current_scope(), {})
            scope[coll] = scope.get(coll, 0.0) + payload
            self.c.n_collectives += 1
        elif name in _DOTS:
            self.c.flops += _dot_flops(name, args, outs[0])
        elif name in _SDPA:
            self.c.flops += _sdpa_flops(args)
        if coll is None and not func.is_view and name not in _NO_TRAFFIC:
            self.c.n_ops += 1
            self.c.memory_bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        if not func.is_view:
            for t in outs:
                self._track(t)
        return out

    def costs(self) -> ModuleCosts:
        self.c.collective_total = sum(self.c.collectives.values())
        # ring-algorithm wire model: all-reduce moves ≈ 2× its payload per card
        self.c.collective_wire = self.c.collective_total + self.c.collectives["all-reduce"]
        return self.c


def collective_bytes(costs: ModuleCosts) -> Dict[str, float]:
    """Per-rank collective payload bytes by type, with the totals."""
    out = dict(costs.collectives)
    out["total"] = costs.collective_total
    out["wire_total"] = costs.collective_wire
    out["by_scope"] = {k: dict(v) for k, v in costs.collectives_by_scope.items()}
    return out


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   coll_bytes_per_device: float, hw: HW = HW()) -> Dict[str, float]:
    """The three roofline times (seconds) for one executed step, per card."""
    t_compute = flops_per_device / hw.peak_flops
    t_memory = bytes_per_device / hw.hbm_bw
    t_coll = coll_bytes_per_device / hw.ici_bw
    terms = {"compute_s": t_compute, "memory_s": t_memory, "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    terms["bottleneck"] = dom.replace("_s", "")
    terms["step_time_lb_s"] = max(t_compute, t_memory, t_coll)
    return terms
