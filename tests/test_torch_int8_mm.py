"""The port's int8 GEMM (``repro_torch.kernels.int8_mm``; its plain PyTorch
version, which the CPU runs) against the JAX package's Pallas kernel in
interpret mode and its oracle, on the same numpy operands.  Mirrors
tests/test_kernels.py: rtol 1e-6 (the int32 accumulate is exact, the
epilogue is the same two float32 multiplies).  The CUDA kernel is held
against the same plain version on the card by chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.int8_mm import int8_matmul as jax_int8_matmul
from repro.kernels.int8_mm import int8_mm_pallas, int8_mm_ref as jax_int8_mm_ref
from repro_torch.kernels.int8_mm import int8_matmul, int8_mm_cuda, int8_mm_fused, int8_mm_ref


@pytest.mark.parametrize("M,K,N,bm,bn,bk", [
    (16, 32, 8, 8, 8, 8), (128, 128, 128, 128, 128, 128),
    (33, 70, 9, 16, 16, 32), (1, 300, 1, 8, 8, 64),
])
def test_int8_mm_matches_jax(M, K, N, bm, bn, bk):
    rng = np.random.default_rng(M + K + N)
    a = rng.integers(-127, 128, (M, K)).astype(np.int8)
    w = rng.integers(-127, 128, (K, N)).astype(np.int8)
    sa = rng.uniform(0.001, 1.0, (M,)).astype(np.float32)
    sw = rng.uniform(0.001, 1.0, (N,)).astype(np.float32)
    pal = np.asarray(int8_mm_pallas(jnp.asarray(a), jnp.asarray(w), jnp.asarray(sa),
                                    jnp.asarray(sw), block_m=bm, block_n=bn, block_k=bk))
    ours = int8_mm_fused(*(torch.from_numpy(x) for x in (a, w, sa, sw)))
    assert ours.dtype == torch.float32 and ours.shape == (M, N)
    np.testing.assert_allclose(ours.numpy(), pal, rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        int8_mm_ref(*(torch.from_numpy(x) for x in (a, w, sa, sw))).numpy(),
        np.asarray(jax_int8_mm_ref(a, w, sa, sw)), rtol=1e-6, atol=0)


def test_int8_matmul_quant_quality_and_parity():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(20, 64)).astype(np.float32)
    w = rng.normal(size=(64, 12)).astype(np.float32)
    y = int8_matmul(torch.from_numpy(x), torch.from_numpy(w))
    ref = x @ w
    assert float(np.abs(y.numpy() - ref).max() / np.abs(ref).max()) < 0.02
    np.testing.assert_allclose(y.numpy(), np.asarray(jax_int8_matmul(x, w)), rtol=1e-6, atol=0)


def test_cuda_path_rejects_cpu_tensors():
    a = torch.zeros((2, 4), dtype=torch.int8)
    s = torch.ones(2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        int8_mm_cuda(a, a.T.contiguous(), s, s)
    assert int8_mm_cuda.launches == 0


def test_kernel_bench_entry_point_on_cpu():
    """The kernel bench runs the plain versions on the CPU, checks them
    against each other, and names the CPU as its device."""
    from repro_torch.launch import kernel_bench
    out = kernel_bench.run(device="cpu", reps=1)
    assert out["device"] == "cpu" and out["timer"] == "host clock"
    assert all(out[k] > 0 for k in ("sc_matmul_plain_ms", "sc_matmul_fused_ms",
                                    "expected_int_surrogate_ms", "int8_mm_fused_ms"))
    assert out["sc_mac_structure"]["tiles"] == (512 // 8) * (512 // 8) * (4096 // 256)


@pytest.mark.parametrize("M,K,N", [(5, 1000, 7), (3, 17, 129), (8, 64, 3), (2, 1, 5),
                                   (257, 1000, 129)])
def test_k_major_operands_give_the_unpadded_product(M, K, N):
    """The kernel's operand preparation (wᵀ written K-major, K padded to a
    multiple of 16 with zeros) gives, through the plain version, exactly
    the unpadded product."""
    from repro_torch.kernels.int8_mm.int8_mm import k_major_operands
    rng = np.random.default_rng(M * K + N)
    a = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8))
    sa = torch.from_numpy(rng.uniform(0.001, 1.0, (M,)).astype(np.float32))
    sw = torch.from_numpy(rng.uniform(0.001, 1.0, (N,)).astype(np.float32))
    a_k, w_t = k_major_operands(a, w)
    k_hat = -(-K // 16) * 16
    assert a_k.shape == (M, k_hat) and w_t.shape == (N, k_hat)
    assert a_k.is_contiguous() and w_t.is_contiguous() and a_k.dtype == w_t.dtype == torch.int8
    assert torch.all(a_k[:, K:] == 0) and torch.all(w_t[:, K:] == 0)
    assert torch.equal(w_t[:, :K], w.t())
    assert torch.equal(int8_mm_ref(a_k, w_t.t(), sa, sw), int8_mm_ref(a, w, sa, sw))


def test_k_major_operands_pad_a_misaligned_a():
    """An ``a`` view that does not start on a 16-byte boundary is copied."""
    from repro_torch.kernels.int8_mm.int8_mm import k_major_operands
    base = torch.arange(5 * 32 + 1, dtype=torch.int32).to(torch.int8)
    a = base[1:].reshape(5, 32)
    w = torch.ones((32, 4), dtype=torch.int8)
    a_k, w_t = k_major_operands(a, w)
    assert a_k.data_ptr() % 16 == 0 and torch.equal(a_k, a)
    aligned = torch.zeros((4, 32), dtype=torch.int8)
    if aligned.data_ptr() % 16 == 0:
        assert k_major_operands(aligned, w)[0] is aligned


@pytest.mark.parametrize("M,K,N", [(2 ** 16, 2 ** 15, 1), (1, 2 ** 15, 2 ** 16),
                                   (2 ** 16, 1, 2 ** 15)])
def test_shapes_the_kernel_cannot_take_are_rejected(M, K, N):
    from repro_torch.kernels.int8_mm.int8_mm import check_shapes
    with pytest.raises(ValueError):
        check_shapes(M, K, N)
    assert check_shapes(4096, 4096, 4096) == 4096 and check_shapes(257, 1000, 129) == 1008
