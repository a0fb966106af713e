"""repro_torch.serving — the continuous-batching serving engine on PyTorch.

* :mod:`repro_torch.serving.blocks`    — KV block pool + swap-tier paged store
* :mod:`repro_torch.serving.scheduler` — request lifecycle / admission / preemption
* :mod:`repro_torch.serving.engine`    — the step-loop driver (ServingEngine)
* :mod:`repro_torch.serving.metrics`   — TTFT/TPOT/occupancy + ODIN PIMC attribution
* :mod:`repro_torch.serving.trace`     — ring-buffered tracer, windowed metrics
* :mod:`repro_torch.serving.workload`  — synthetic open-loop arrival generators
* :mod:`repro_torch.serving.faults`    — fault-plan types and typed errors
* :mod:`repro_torch.serving.degrade`   — load-shedding ladder
* :mod:`repro_torch.serving.reliability` — PCRAM endurance/wear/scrub knobs
* :mod:`repro_torch.serving.frontdoor` — asyncio streaming front door
  (backpressure, per-tenant QoS, typed rejections, SSE server)

The host-only modules are copies of the JAX package's.

Quick start::

    from repro_torch.models import registry
    from repro_torch.serving import ServingEngine, SCENARIOS, make_requests

    cfg = registry.get_smoke("phi4-mini-3.8b")
    eng = ServingEngine(cfg, slots=4, max_len=96, block_size=16)   # on CUDA
    summary = eng.run(make_requests(cfg, SCENARIOS["mixed"], seed=0))
"""
from repro_torch.serving.blocks import BlockPool, PagedKVStore, SwapTicket
from repro_torch.serving.degrade import (DEGRADE_LEVELS, DegradationController,
                                         DegradeConfig)
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.faults import (FAULT_SITES, EngineStallError, FaultEvent,
                                        FaultPlan, Overloaded, ShuttingDown,
                                        SwapCopyError)
from repro_torch.serving.frontdoor import (DoneEvent, FrontDoor, HeartbeatEvent,
                                           TokenBucket, TokenEvent, run_server)
from repro_torch.serving.metrics import EngineStats, OdinCostModel, summarize
from repro_torch.serving.reliability import ReliabilityConfig, wear_gini
from repro_torch.serving.scheduler import (TERMINAL_STATES, PrefixCache, PrefixGrant,
                                           Request, RequestState, Scheduler,
                                           StepPlan)
from repro_torch.serving.trace import (NULL_TRACER, LogHistogram, MetricsRegistry,
                                       NullTracer, Tracer, chrome_trace,
                                       validate_chrome_trace)
from repro_torch.serving.workload import (SCENARIOS, WorkloadSpec, make_requests,
                                          poisson_arrivals)

__all__ = [
    "BlockPool", "PagedKVStore", "SwapTicket",
    "ServingEngine",
    "EngineStats", "OdinCostModel", "summarize",
    "PrefixCache", "PrefixGrant",
    "Request", "RequestState", "Scheduler", "StepPlan", "TERMINAL_STATES",
    "FaultPlan", "FaultEvent", "FAULT_SITES",
    "EngineStallError", "SwapCopyError", "Overloaded", "ShuttingDown",
    "FrontDoor", "TokenBucket", "TokenEvent", "HeartbeatEvent", "DoneEvent",
    "run_server",
    "DegradationController", "DegradeConfig", "DEGRADE_LEVELS",
    "ReliabilityConfig", "wear_gini",
    "Tracer", "NullTracer", "NULL_TRACER", "LogHistogram", "MetricsRegistry",
    "chrome_trace", "validate_chrome_trace",
    "SCENARIOS", "WorkloadSpec", "make_requests", "poisson_arrivals",
]
