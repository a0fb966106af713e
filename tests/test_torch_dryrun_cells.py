"""Every dry-run cell of every arch at smoke size on fake meshes, and the
collectives of the sharded decode attention.

* Each arch's smoke ``prefill_32k``, ``decode_32k`` and (hymba, xlstm)
  ``long_500k`` cell traces OK on a 2 × 2 fake mesh (its ``train_4k`` cell is
  ``tests/test_torch_dryrun.py``'s), and every cell, ``train_4k`` included,
  on a (2, 4) one, whose ``model`` axis of 4 is wider than the smoke
  configs' 2 KV heads and xlstm's 2 heads: attention and the recurrences
  then run replicated over it, as the production mesh's 16 is wider than
  many full configs' heads.
* The decode attention over a sequence-sharded cache (GQA's K/V, MLA's
  latents) moves partials, not the cache: under ``hlo.CostCounter`` its
  only collectives are the all-reduces of the ``[B, H]`` row max and
  denominator and the ``[B, H, Dv]`` numerator; MLA's up-projections,
  sharded, are gathered as weights, and nothing else is gathered.

A fake process group is process-global: each test opens and closes its own
(``dryrun.fake_group``).
"""
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import AttnConfig  # noqa: E402
from repro_torch.launch import dryrun, hlo  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.nn import attention  # noqa: E402
from repro_torch.nn.module import P  # noqa: E402

MESHES = {"2x2": (2, 2), "2x4": (2, 4)}
CELLS = [(m, a, s.name) for m in MESHES for a, s in registry.cells()
         if not (m == "2x2" and s.name == "train_4k")]


@pytest.fixture(scope="module")
def records():
    recs = {}
    for name, shape in MESHES.items():
        with dryrun.fake_group(shape[0] * shape[1]):
            mesh = make_mesh(shape, ("data", "model"), "cpu")
            for m, arch, cell in CELLS:
                if m == name:
                    recs[m, arch, cell] = dryrun.run_cell(arch, cell, mesh=mesh, smoke=True)
    return recs


def test_every_cell_is_attempted():
    assert len(CELLS) == 2 * 10 + 2 + 32 and len(registry.cells()) == 32


@pytest.mark.parametrize("mesh,arch,cell", CELLS)
def test_smoke_cell_on_a_fake_mesh(records, mesh, arch, cell):
    rec = records[mesh, arch, cell]
    assert rec["status"] == "OK", rec.get("error")
    json.dumps(rec, allow_nan=False)
    mem, cost, roof = rec["memory"], rec["cost"], rec["roofline"]
    assert rec["n_devices"] == MESHES[mesh][0] * MESHES[mesh][1]
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
    assert mem["total_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                  + mem["temp_bytes"] - mem["alias_bytes"])
    assert cost["flops"] > 0 and cost["bytes_accessed"] > 0
    assert cost["n_collectives"] == cost["comm_debug_collectives"] > 0
    coll = rec["collectives"]
    assert coll["total"] > 0
    assert sum(sum(v.values()) for v in coll["by_scope"].values()) == coll["total"]
    assert roof["bottleneck"] in ("compute", "memory", "collective")
    assert 0 < roof["useful_flops_ratio"] and rec["fits_hbm"]


def _decode_counts(mla: bool, weights_sharded: bool = False):
    """One decode attention step over a cache of 16 rows sharded 2 ways on
    ``model``, 4 slots sharded 2 ways on ``data``: (the counter's costs,
    local batch, heads, value width)."""
    B, Sk, H = 4, 16, 4
    dt = torch.float32
    with dryrun.fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        q_pos = torch.full((B, 1), Sk - 1, dtype=torch.int32, device="meta")
        k_pos = torch.arange(Sk, dtype=torch.int32, device="meta").expand(B, Sk)
        rows = dryrun._fake
        if mla:
            cfg = AttnConfig(kind="mla", n_heads=H, n_kv_heads=H, d_head=16, kv_lora_rank=32,
                             qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
            w_ps = P(None, "model") if weights_sharded else P()
            p = {"k_up": rows((32, H * 16), dt, mesh, w_ps),
                 "v_up": rows((32, H * 16), dt, mesh, w_ps)}
            args = (p, rows((B, 1, H, 16), dt, mesh, P("data")),
                    rows((B, 1, H, 8), dt, mesh, P("data")),
                    rows((B, Sk, 32), dt, mesh, P("data", "model")),
                    rows((B, Sk, 8), dt, mesh, P("data", "model")), cfg, q_pos, k_pos)
            run, Dv = attention.mla_decompress_attend, 16
        else:
            args = (rows((B, 1, H, 32), dt, mesh, P("data")),
                    rows((B, Sk, 2, 32), dt, mesh, P("data", "model")),
                    rows((B, Sk, 2, 32), dt, mesh, P("data", "model")), q_pos, k_pos)
            run, Dv = attention.sdpa, 32
        with hlo.CostCounter() as counter:
            out = run(*args)
        assert tuple(out.shape) == (B, 1, H, Dv)
        assert out.to_local().shape == (B // 2, 1, H, Dv)
    return counter.costs(), B // 2, H, Dv


@pytest.mark.parametrize("mla", [False, True], ids=["gqa", "mla"])
def test_decode_attention_reduces_partials_not_the_cache(mla):
    costs, Bl, H, Dv = _decode_counts(mla)
    partials = 4 * (Bl * H + Bl * H + Bl * H * Dv)       # float32 [B, H] twice, [B, H, Dv]
    assert costs.n_collectives == 3
    assert costs.collectives["all-reduce"] == partials
    assert costs.collectives["all-gather"] == costs.collectives["all-to-all"] == 0
    assert costs.collectives_by_scope == {"attention partials": {"all-reduce": partials}}


def test_mla_decode_gathers_only_its_weights():
    """Sharded ``k_up``/``v_up`` are gathered whole (a weight, ``[32, 64]``
    float32 each), the latent rows never."""
    costs, Bl, H, Dv = _decode_counts(True, weights_sharded=True)
    weights = 2 * 4 * 32 * 64 // 2                        # each rank's half of both
    assert costs.collectives_by_scope["weights"] == {"all-gather": weights}
    assert costs.collectives_by_scope["attention partials"] == {
        "all-reduce": 4 * (2 * Bl * H + Bl * H * Dv)}
    assert set(costs.collectives_by_scope) == {"weights", "attention partials"}
