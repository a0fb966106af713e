"""The port's sharding rules and partition-spec trees against the JAX
package's own functions (pure Python: no process group, no JAX devices).

Both packages' functions read a mesh through ``axis_names`` and a ``shape``
mapping, so one stand-in serves both.  Every param pspec tree of every
arch's full config, on the (16, 16) and (2, 16, 16) production meshes, the
optimizer, batch and cache trees, and every dry-run cell's abstract inputs
are compared entry for entry.
"""
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.nn import module as jmod  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.nn import module as tmod  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402


class StandIn:
    def __init__(self, shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


MESHES = {
    "pod1": StandIn({"data": 16, "model": 16}),
    "pod2": StandIn({"pod": 2, "data": 16, "model": 16}),
}


def _flat_jax(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {jax.tree_util.keystr(p): x for p, x in flat}


def _flat_port(tree, path=""):
    if isinstance(tree, tmod.P) or not isinstance(tree, (dict, list, tuple)):
        return {path: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat_port(v, f"{path}[{k!r}]"))
    return out


def _same_specs(jtree, ttree):
    j, t = _flat_jax(jtree), _flat_port(ttree)
    assert set(j) == set(t), sorted(set(j) ^ set(t))[:6]
    bad = {k: (j[k], t[k]) for k in j if tuple(j[k]) != tuple(t[k])}
    assert not bad, list(bad.items())[:4]
    return len(j)


def test_port_spec_is_a_plain_tuple():
    assert tmod.P("data", None) == ("data", None)
    assert tuple(JP(("pod", "data"), "model")) == tuple(tmod.P(("pod", "data"), "model"))
    assert tmod.P() == ()


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_sharding_rules_match_jax(mesh, kind):
    m = MESHES[mesh]
    assert tmesh.sharding_rules(m, kind) == jmesh.sharding_rules(m, kind)
    over = {"act_seq": None, "embed": ("data", "model")}
    assert tmesh.sharding_rules(m, kind, **over) == jmesh.sharding_rules(m, kind, **over)
    assert tmesh.batch_axes(m) == jmesh.batch_axes(m)


@pytest.mark.parametrize("axes", [
    ("embed", "mlp"), ("vocab", "embed"), ("layers", "embed", "heads_flat"),
    ("experts", "embed", "mlp"), ("embed", "embed"), ("mlp", "heads_flat"),
    ("batch", "act_seq", None), (None, None), ("capacity", "batch"),
])
def test_logical_to_pspec_matches_jax(axes):
    for m in MESHES.values():
        rules = jmesh.sharding_rules(m, "train")
        assert tuple(tmod.logical_to_pspec(axes, rules)) == \
            tuple(jmod.logical_to_pspec(axes, rules))
    # a tuple rule value whose axes repeat an earlier entry loses them
    rules = {"a": ("data", "model"), "b": "model", "c": ("model", "data")}
    for ax in [("a", "b"), ("b", "a"), ("c", "a", "b")]:
        assert tuple(tmod.logical_to_pspec(ax, rules)) == tuple(jmod.logical_to_pspec(ax, rules))


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_param_pspecs_of_every_full_config_match_jax(arch):
    jspec, tspec = jlm.param_spec(jreg.get_config(arch)), tlm.param_spec(treg.get_config(arch))
    for m in MESHES.values():
        rules = jmesh.sharding_rules(m, "train")
        n = _same_specs(jmesh.param_pspecs(jspec, rules, m), tmesh.param_pspecs(tspec, rules, m))
        _same_specs(jmesh.param_pspecs(jspec, rules), tmesh.param_pspecs(tspec, rules))
        _same_specs(jmod.pspec_tree(jspec, rules), tmod.pspec_tree(tspec, rules))
        assert n > 5
    # abstract(): the same shapes and dtypes, nothing allocated
    ja, ta = _flat_jax(jmod.abstract(jspec)), _flat_port(tmod.abstract(tspec))
    assert set(ja) == set(ta)
    for k, a in ja.items():
        assert tuple(a.shape) == tuple(ta[k].shape) and ta[k].is_meta
        assert str(a.dtype) == str(ta[k].dtype).replace("torch.", ""), k


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_optimizer_pspecs_match_jax(moments):
    for arch in ("phi4-mini-3.8b", "deepseek-v3-671b"):
        jspec, tspec = jlm.param_spec(jreg.get_config(arch)), tlm.param_spec(treg.get_config(arch))
        for m in MESHES.values():
            rules = jmesh.sharding_rules(m, "train")
            jps = jmesh.param_pspecs(jspec, rules, m)
            tps = tmesh.param_pspecs(tspec, rules, m)
            _same_specs(jsteps.optimizer_pspecs(jps, JAdamWConfig(moment_dtype=moments)),
                        tsteps.optimizer_pspecs(tps, AdamWConfig(moment_dtype=moments)))


def test_dryrun_tables_match_jax():
    assert tspecs.DRYRUN_ACCUM == jspecs.DRYRUN_ACCUM
    assert tspecs.DRYRUN_ACCUM_DTYPE == jspecs.DRYRUN_ACCUM_DTYPE


def test_cells_and_skip_reasons_match_jax():
    tc = [(a, s.name, s.seq_len, s.global_batch, s.kind) for a, s in treg.cells()]
    jc = [(a, s.name, s.seq_len, s.global_batch, s.kind) for a, s in jreg.cells()]
    assert tc == jc and len(tc) == 32
    for arch in treg.ARCH_IDS:
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            assert treg.skip_reason(arch, shape) == jreg.skip_reason(arch, shape)


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_batch_and_cache_pspecs_match_jax(arch):
    from repro.configs.base import LM_SHAPES as JSHAPES
    from repro_torch.configs.base import LM_SHAPES as TSHAPES

    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for m in MESHES.values():
        for shape in ("train_4k", "prefill_32k"):
            for accum in sorted({1, jspecs.DRYRUN_ACCUM[arch]}):
                jb = jspecs.batch_pspecs(jcfg, JSHAPES[shape], m, accum)
                tb = tspecs.batch_pspecs(tcfg, TSHAPES[shape], m, accum)
                assert {k: tuple(v) for k, v in jb.items()} == {k: tuple(v) for k, v in tb.items()}
        B, S = TSHAPES["decode_32k"].global_batch, TSHAPES["decode_32k"].seq_len
        jc = jspecs.abstract_caches(jcfg, B, S)
        tc = tspecs.abstract_caches(tcfg, B, S)
        _same_specs(jspecs.cache_pspecs(jcfg, jc, m), tspecs.cache_pspecs(tcfg, tc, m))


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_input_specs_of_every_cell_match_jax(arch):
    for a, shape in treg.cells():
        if a != arch:
            continue
        for smoke in (False, True):
            j = jspecs.input_specs(arch, shape.name, smoke=smoke)
            t = tspecs.input_specs(arch, shape.name, smoke=smoke)
            assert (j["kind"], j["accum"]) == (t["kind"], t["accum"])
            assert tuple(j["shape"].__dict__.values()) == tuple(t["shape"].__dict__.values())
            keys = ("batch",) if j["kind"] != "decode" else ("tokens", "caches")
            for k in keys:
                assert _shapes(t[k]) == _shapes(j[k]), (arch, shape.name, k)
