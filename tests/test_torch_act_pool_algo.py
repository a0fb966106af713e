"""The CUDA act_pool kernel's algorithm, run in plain PyTorch by
``act_pool_kernel_ref``: the max kinds reduce the raw int32 window and
activate once, the avg tanh reads the 222-entry table.  Held bit for bit
against the JAX package's ``act_pool_ref`` and its Pallas kernel in
interpret mode on every case of ``test_torch_act_pool.py``, on every
integer of [-2^16, 2^16) through the tanh, on the int32 extremes and at
pools of 5 to 7 (the kernel's loop for any pool size).  Also the table
itself (its entries, its 0/255 boundaries, the margin that makes a float32
tanh round to the exact value), the plain version's tanh on its first
multi-threaded call in fresh processes, and the kernel's launch plan."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels.act_pool import act_pool as jax_act_pool
from repro.kernels.act_pool import act_pool_ref
import repro_torch
from repro_torch.kernels.act_pool import act_pool_kernel_ref, launch_plan, tanh_table
from repro_torch.kernels.act_pool.act_pool import CTAS_PER_SM, THREADS, UNROLL
from repro_torch.kernels.act_pool.ref import TANH_TABLE_LEN, tanh8
from test_torch_act_pool import CASES

jax_act_pool_ref = jax.jit(act_pool_ref, static_argnums=(1, 2, 3))
I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1
KINDS = [(a, k) for a in ("relu", "tanh") for k in ("max", "avg")]
H100_SMS = 132


def _hold(x, pool, act, kind):
    ours = act_pool_kernel_ref(torch.from_numpy(x), pool, act, kind)
    assert ours.dtype == torch.int32
    ref = np.asarray(jax_act_pool_ref(jnp.asarray(x), pool, act, kind))
    pallas = np.asarray(jax_act_pool(jnp.asarray(x), pool=pool, act=act, pool_kind=kind))
    np.testing.assert_array_equal(pallas, ref)
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_algorithm_matches_jax_on_every_case(name):
    x, pool, act, kind = CASES[name]
    _hold(x, pool, act, kind)


def _tanh_wide():
    """Every integer in [-2^16, 2^16), one per pixel."""
    return np.arange(-2 ** 16, 2 ** 16, dtype=np.int32).reshape(1, 256, 512, 1)


@pytest.mark.parametrize("kind", ["max", "avg"])
def test_tanh_over_every_integer_in_2_to_16(kind):
    _hold(_tanh_wide(), 1, "tanh", kind)


def _int32_extremes():
    """Windows of int32 extremes mixed with values in and around the
    activations' ranges, so a window's max may be either extreme."""
    rng = np.random.default_rng(21)
    vals = np.array([I32_MIN, I32_MIN + 1, -I32_MAX // 2, -1, 0, 1, 170, 221, 222, 255, 256,
                     I32_MAX // 2, I32_MAX - 1, I32_MAX], np.int64)
    return vals[rng.integers(0, vals.size, (2, 12, 12, 5))].astype(np.int32)


@pytest.mark.parametrize("pool", [1, 2, 3, 4])
@pytest.mark.parametrize("act,kind", KINDS)
def test_int32_extremes(act, kind, pool):
    _hold(_int32_extremes(), pool, act, kind)


@pytest.mark.parametrize("pool", [5, 6, 7])
@pytest.mark.parametrize("act,kind", KINDS)
def test_generic_pool_sizes(act, kind, pool):
    """Pools past 4 run the kernel's loop for any p."""
    x = np.random.default_rng(pool).integers(-300, 600, (2, 2 * pool, 3 * pool, 5))
    _hold(x.astype(np.int32), pool, act, kind)


# A fresh process with 8 threads, whose first tanh is over CNN1's conv map at
# batch 64 (200,704 elements, 2×2 max after): float32 CPU ``torch.tanh``
# (PyTorch 2.13) has computed one thread's share of such a call some 1e-4
# off in one process of four to sixteen, enough to give 255 for x = 221 and
# 180 for x = 56.  The plain version's tanh must give the exact values
# always.  With the float32 tanh, 36 processes six at a time found one to
# three wrong in each of four runs.
_FRESH_TANH = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(8)
    from repro_torch.kernels.act_pool.ref import act_pool_ref
    x = np.random.default_rng(13).integers(-300, 600, (64, 28, 28, 4)).astype(np.int32)
    out = act_pool_ref(torch.from_numpy(x), 2, "tanh", "max").numpy()
    exact = np.clip(np.rint(255.0 * np.tanh(x / 64.0)), 0, 255).astype(np.int32)
    exact = exact.reshape(64, 14, 2, 14, 2, 4).max(axis=(2, 4))
    sys.exit(int(not np.array_equal(out, exact)))
""")


def test_plain_tanh_exact_on_first_multithreaded_call():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(repro_torch.__file__)), os.environ.get("PYTHONPATH", "")]))
    failed = 0
    for _ in range(6):
        procs = [subprocess.Popen([sys.executable, "-c", _FRESH_TANH], env=env)
                 for _ in range(6)]
        failed += sum(p.wait(timeout=120) != 0 for p in procs)
    assert failed == 0, f"{failed} of 36 fresh processes computed a wrong 8-bit tanh"


def test_table_entries_match_the_jax_formula():
    x = jnp.arange(TANH_TABLE_LEN, dtype=jnp.int32)
    jax_tanh8 = jnp.clip(jnp.round(255.0 * jnp.tanh(x.astype(jnp.float32) / 64.0)),
                         0, 255).astype(jnp.int32)
    table = tanh_table()
    assert table.dtype == torch.int32 and tuple(table.shape) == (TANH_TABLE_LEN,)
    np.testing.assert_array_equal(table.numpy(), np.asarray(jax_tanh8))
    # 119 values in all: 0, 255 and 117 between them
    assert len(np.unique(table.numpy()[1:])) == 117 and table.numpy()[1:].min() > 0


def test_table_boundaries():
    """0 up to x = 0 and 255 from x = 222 on; in between, 1..254."""
    table = tanh_table()
    assert table[0].item() == 0 and table[1].item() > 0
    assert table[TANH_TABLE_LEN - 1].item() == 254
    edges = torch.tensor([I32_MIN, -1, 0, 1, 221, 222, 223, I32_MAX], dtype=torch.int32)
    assert tanh8(edges).tolist() == [0, 0, 0, table[1].item(), 254, 255, 255, 255]
    assert bool((tanh8(torch.arange(TANH_TABLE_LEN, 2 ** 16, dtype=torch.int32)) == 255).all())
    assert bool((tanh8(torch.arange(-2 ** 16, 1, dtype=torch.int32)) == 0).all())


def test_tanh_is_monotone_so_max_commutes():
    """act(max(window)) == max(act(window)) needs a non-decreasing act."""
    x = torch.from_numpy(_tanh_wide().ravel())
    assert bool((torch.diff(tanh8(x)) >= 0).all())


@pytest.mark.parametrize("lo,hi", [(0, TANH_TABLE_LEN), (-2 ** 16, 2 ** 16)])
def test_no_integer_lies_near_a_rounding_tie(lo, hi):
    """In float64, 255·tanh(x/64) stays ≥ 1.7e-3 from every half-integer,
    so any float32 tanh within a few ulps rounds to the exact value and the
    table is the function; the nearest are x = ±170."""
    x = np.arange(lo, hi, dtype=np.float64)
    y = 255.0 * np.tanh(x / 64.0)
    gap = np.abs(y - np.floor(y) - 0.5)
    assert gap.min() >= 1.7e-3
    assert abs(x[np.argmin(gap)]) == 170


@pytest.mark.parametrize("shape,pool", [((64, 28, 28, 4), 2), ((64, 22, 22, 10), 2),
                                        ((8, 224, 224, 64), 2), ((1, 2, 2, 4), 2),
                                        ((8, 64, 64, 65), 2), ((2, 9, 15, 4), 3)])
@pytest.mark.parametrize("aligned", [True, False])
def test_launch_plan_covers_every_item(shape, pool, aligned):
    B, H, W, C = shape
    plan = launch_plan(shape, pool, aligned, H100_SMS)
    assert plan["vec"] == (aligned and C % 4 == 0)
    assert plan["items"] * (4 if plan["vec"] else 1) == B * (H // pool) * (W // pool) * C
    assert 1 <= plan["grid"] <= H100_SMS * CTAS_PER_SM
    per_pass = plan["grid"] * THREADS * UNROLL
    assert (plan["passes"] - 1) * per_pass < plan["items"] <= plan["passes"] * per_pass


def test_launch_plan_grid():
    """Two items a thread, a CTA for every 512 items up to 4 CTAs an SM;
    past that, several passes."""
    small = launch_plan((64, 28, 28, 4), 2, True, H100_SMS)
    assert small == {"vec": True, "items": 12544, "grid": 25, "passes": 1}
    assert launch_plan((1, 2, 2, 3), 2, True, H100_SMS)["grid"] == 1
    vgg = launch_plan((8, 224, 224, 64), 2, True, H100_SMS)
    assert vgg["grid"] == H100_SMS * CTAS_PER_SM and vgg["passes"] == 6
