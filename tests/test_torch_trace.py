"""The port's tracing on the CPU: profiler ranges entered only while the
profiler records (``repro_torch.obs``), the engine's host phases
(``serving/trace.py StepPhases``) as fields of its dispatch spans and as
``serving/*`` ranges, and the model's ``attn/core`` and ``optim/adamw``
ranges; tiny dense and MoE engines, an MLA attention call and a tiny train
step."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs.base import AttnConfig, ShapeConfig
from repro_torch.launch.specs import concrete_batch
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm, registry
from repro_torch.nn import attention
from repro_torch.nn.module import materialize
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.serving import Request, ServingEngine, Tracer
from repro_torch.serving.trace import PHASES

ARCHS = {"dense": "phi4-mini-3.8b", "moe": "qwen3-moe-235b-a22b"}
FIELDS = [f"{p}_s" for p in PHASES]
# the clock reads of a step with the tracer off, as the engine read them
# before the phases: the step's start, the dispatch's start and end, the
# emission's time and the metrics window's roll
UNTRACED_READS = 5


class CountingClock:
    """An engine clock that reads 1, 2, 3, ...: every reading counted, and
    every phase a whole number of seconds."""

    def __init__(self):
        self.n = 0

    def __call__(self):
        self.n += 1
        return float(self.n)


def serve(arch, *, tracer=None, clock=None, annotations=False):
    """Two requests over two slots to the end: a mixed tile, then decode
    steps.  Returns the engine clock's count before and after each step
    (``clock`` a ``CountingClock``) or None."""
    cfg = registry.get_smoke(ARCHS[arch])
    eng = ServingEngine(cfg, slots=2, max_len=32, block_size=8, device="cpu", seed=0,
                        tracer=tracer, clock=clock, xla_annotations=annotations)
    rng = np.random.default_rng(0)
    for i in range(2):
        eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, 5 + 3 * i).astype(np.int32),
                           max_new=4, arrival=0.0))
    counts = []
    while eng.sched.has_work:
        n0 = clock.n if clock is not None else None
        eng.step()
        counts.append((n0, clock.n if clock is not None else None))
    return counts


def train_step():
    """A train step of the dense smoke model on 2 x 16 tokens."""
    cfg = registry.get_smoke(ARCHS["dense"])
    params = materialize(lm.param_spec(cfg), torch.Generator().manual_seed(0), "cpu")
    opt_cfg = AdamWConfig(moment_dtype="int8")
    opt = adamw_init(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg, warmup=1)
    step(params, opt, concrete_batch(cfg, ShapeConfig("train", 16, 2, "train"), 0, 0))


def profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof.events()


def dispatch_spans(tracer):
    return [e for e in tracer.events() if e.cat == "dispatch" and e.name in ("mixed", "decode")]


def test_no_range_is_entered_without_the_profiler(monkeypatch):
    entered = []
    real = obs.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(obs, "record_function", counting)
    serve("dense", tracer=Tracer(), annotations=True)
    train_step()
    assert entered == []
    # the same calls under the profiler go through the patched function
    profiled(lambda: serve("dense", annotations=True))
    assert "serving/enqueue" in entered and "attn/core" in entered


@pytest.mark.parametrize("annotations", [False, True])
def test_untraced_steps_record_nothing_and_read_no_extra_clock(annotations):
    tracer = Tracer()
    tracer.enabled = False
    clock = CountingClock()
    counts = serve("dense", tracer=tracer, clock=clock, annotations=annotations)
    assert [b - a for a, b in counts] == [UNTRACED_READS] * len(counts)
    assert len(tracer) == 0


@pytest.mark.parametrize("arch", list(ARCHS))
def test_span_fields_sum_to_the_step(arch):
    tracer, clock = Tracer(), CountingClock()
    counts = serve(arch, tracer=tracer, clock=clock)
    spans = dispatch_spans(tracer)
    assert {s.name for s in spans} == {"mixed", "decode"}
    assert len(spans) == len(counts)            # every step dispatched once
    for (n0, n1), s in zip(counts, spans):
        f = [s.args[k] for k in FIELDS]
        assert min(f) >= 0, s.args
        # the engine clock is the counting clock less its first reading (1,
        # as the engine is built): the span lies inside its step
        assert n0 + 1 <= s.ts + 1 and s.ts + 1 + s.dur <= n1
        assert sum(f) == n1 - (n0 + 1)          # the step's first to its last reading
        assert s.args["upload_s"] + s.args["enqueue_s"] + s.args["sync_s"] == s.dur


@pytest.mark.parametrize("arch", list(ARCHS))
def test_the_profiler_sees_every_range_nested_as_the_engine_runs_them(arch):
    events = profiled(lambda: serve(arch, annotations=True))
    by_name = {}
    for e in events:
        by_name.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    want = {f"serving/{p}" for p in PHASES} | {"serving/mixed", "serving/decode", "attn/core"}
    assert want <= set(by_name), want - set(by_name)
    dispatches = by_name["serving/mixed"] + by_name["serving/decode"]

    def inside(rng):
        return any(a <= rng[0] and rng[1] <= b for a, b in dispatches)

    for p in PHASES:
        assert all(inside(r) == (p in ("upload", "enqueue", "sync"))
                   for r in by_name[f"serving/{p}"]), p


def test_enqueue_ranges_share_the_spans_clock():
    tracer = Tracer()
    events = profiled(lambda: serve("dense", tracer=tracer, annotations=True))
    ranges = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.name == "serving/enqueue")
    spans = dispatch_spans(tracer)
    assert len(ranges) == len(spans) > 0
    for (a, b), s in zip(ranges, spans):
        assert abs((b - a) / 1e6 - s.args["enqueue_s"]) < 1e-3


def test_model_ranges_mla_cache_and_adamw():
    cfg = AttnConfig(kind="mla", n_heads=4, n_kv_heads=4, d_head=16, q_lora_rank=32,
                     kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
    p = materialize(attention.attn_spec(cfg, 64), torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(2, 4, 64)
    cached = {e.name for e in profiled(lambda: attention.attention(
        p, x, cfg, cache=attention.init_cache(cfg, 2, 8, dtype=torch.float32)))}
    uncached = {e.name for e in profiled(lambda: attention.attention(p, x, cfg))}
    assert "attn/core" in cached and "attn/core" not in uncached
    trained = {e.name for e in profiled(train_step)}
    # the train step's attention takes no cache: no attn/core range there
    assert "optim/adamw" in trained and "attn/core" not in trained
