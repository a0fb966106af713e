"""The port's paged attention (its plain PyTorch path, which the CPU runs)
against the JAX package's Pallas kernel in interpret mode and its oracle,
on the same numpy inputs.  Bounds are the JAX suite's own for float32
(tests/test_paged_attn.py): atol 3e-5, rtol 1e-4.  The CUDA kernel itself is
held against the same plain path on the card by chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.paged_attn import paged_attention as jax_paged_attention
from repro.kernels.paged_attn import paged_attn_ref as jax_paged_attn_ref
from repro_torch.kernels.paged_attn import paged_attention
from repro_torch.nn.attention import KV_SCALE

ATOL, RTOL = 3e-5, 1e-4
B, HKV, D, BS, P = 3, 2, 16, 8, 5


def _inputs(seed, G, Q, int8, special):
    rng = np.random.default_rng(seed)
    N = B * P + 3
    q = (rng.normal(size=(B, Q, HKV * G, D)) * 0.5).astype(np.float32)
    if int8:
        kp = rng.integers(-127, 128, (N, BS, HKV, D)).astype(np.int8)
        vp = rng.integers(-127, 128, (N, BS, HKV, D)).astype(np.int8)
    else:
        kp = (rng.normal(size=(N, BS, HKV, D)) * 0.5).astype(np.float32)
        vp = (rng.normal(size=(N, BS, HKV, D)) * 0.5).astype(np.float32)
    tables = rng.permutation(N)[:B * P].reshape(B, P).astype(np.int32)
    lengths = rng.integers(Q, P * BS + 1, B).astype(np.int32)
    if special == "zero_len":
        lengths[0] = 0                       # idle slot: every row is exactly 0
    elif special == "masked_rows":
        lengths[1] = 1                       # rows of queries 0..Q-2 see no key
    elif special == "dup_blocks":
        tables[1, :3] = tables[0, :3]        # slots share physical blocks
        tables[2, 1] = tables[0, 1]
    return q, kp, vp, tables, lengths


CASES = [
    # G, Q, window, int8, special
    (3, 1, 0, False, None),
    (3, 1, 6, False, None),
    (1, 1, 0, True, None),
    (1, 3, 7, False, None),
    (3, 3, 0, True, None),
    (3, 3, 5, True, None),
    (3, 1, 0, False, "zero_len"),
    (3, 3, 0, False, "masked_rows"),
    (1, 3, 4, False, "masked_rows"),
    (3, 1, 0, False, "dup_blocks"),
    (3, 3, 9, True, "dup_blocks"),
]


@pytest.mark.parametrize("G,Q,window,int8,special", CASES)
def test_plain_path_matches_jax_kernel_and_oracle(G, Q, window, int8, special):
    q, kp, vp, tables, lengths = _inputs(G * 100 + Q * 10 + window, G, Q, int8, special)
    kv_scale = KV_SCALE if int8 else None
    qq = q[:, 0] if Q == 1 else q
    ours = paged_attention(torch.from_numpy(qq), torch.from_numpy(kp),
                           torch.from_numpy(vp), torch.from_numpy(tables),
                           torch.from_numpy(lengths), window=window,
                           kv_scale=kv_scale).numpy()
    kernel = np.asarray(jax_paged_attention(
        jnp.asarray(qq), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(lengths), window=window, kv_scale=kv_scale, interpret=True))
    oracle = np.asarray(jax_paged_attention(
        jnp.asarray(qq), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(lengths), window=window, kv_scale=kv_scale, use_kernel=False))
    assert ours.shape == kernel.shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, kernel, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ours, oracle, atol=ATOL, rtol=RTOL)
    if special == "zero_len":
        assert np.all(ours[0] == 0.0) and np.all(kernel[0] == 0.0)
    if special == "masked_rows":
        dead = ours[1, :Q - 1]               # queries at negative positions
        assert np.all(dead == 0.0) and np.all(kernel[1, :Q - 1] == 0.0)


def test_packed_oracle_is_the_jax_oracle():
    """The port's ref.py on a packed tile equals the JAX ref.py."""
    from repro_torch.kernels.paged_attn import paged_attn_ref
    q, kp, vp, tables, lengths = _inputs(5, 3, 3, False, None)
    qt = q.reshape(B, 3, HKV, 3, D).transpose(0, 2, 1, 3, 4).reshape(B, HKV, 9, D)
    ours = paged_attn_ref(torch.from_numpy(qt), torch.from_numpy(kp),
                          torch.from_numpy(vp), torch.from_numpy(tables),
                          torch.from_numpy(lengths), window=3, q_len=3).numpy()
    theirs = np.asarray(jax_paged_attn_ref(
        jnp.asarray(qt), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(lengths), window=3, q_len=3))
    np.testing.assert_allclose(ours, theirs, atol=ATOL, rtol=RTOL)


def test_wrapper_counts_no_launch_on_cpu_and_rejects_other_devices():
    q, kp, vp, tables, lengths = _inputs(0, 3, 1, False, None)
    before = paged_attention.launches
    paged_attention(torch.from_numpy(q[:, 0]), torch.from_numpy(kp),
                    torch.from_numpy(vp), torch.from_numpy(tables),
                    torch.from_numpy(lengths))
    assert paged_attention.launches == before
    with pytest.raises(ValueError):
        paged_attention(torch.from_numpy(q[:, 0]).to("meta"), torch.from_numpy(kp),
                        torch.from_numpy(vp), torch.from_numpy(tables),
                        torch.from_numpy(lengths))
