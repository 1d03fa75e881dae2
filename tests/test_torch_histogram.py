"""Dense histograms of the PyTorch port vs the JAX package.

The same numpy-seeded codes and validity go through the JAX `histogram`,
the Pallas kernel in interpret mode (as tests/test_pallas.py runs it),
the port's `dense_counts` (all three methods) and the CUDA kernel's
plain twin.  Counts are integers: equality is exact.  The kernel itself
runs only on a CUDA card (the `cuda` test at the end).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from findkmer_tpu.ops.histogram import histogram as jax_histogram
from findkmer_tpu.ops.pallas.histogram_kernel import histogram_pallas
from findkmer_torch.ops import histogram as th
from findkmer_torch.ops.cuda import histogram_kernel as hk

torch.set_num_threads(1)  # six test workers share the cores


def _inputs(k, shape=(4, 128), seed=None):
    rng = np.random.default_rng(k if seed is None else seed)
    codes = rng.integers(0, 4 ** k, shape).astype(np.int32)
    valid = rng.random(shape) < 0.8
    # invalid windows carry arbitrary codes, out of range included
    codes[~valid & (rng.random(shape) < 0.5)] = -7
    return codes, valid


@pytest.fixture(scope="module")
def jax_hists():
    """k -> (JAX histogram, Pallas interpret histogram) of _inputs(k)."""
    out = {}
    for k in (4, 8, 10):
        codes, valid = _inputs(k)
        jc, jv = jnp.asarray(codes), jnp.asarray(valid)
        out[k] = (
            np.asarray(jax_histogram(jc, jv, 4 ** k)),
            np.asarray(histogram_pallas(jc, jv, k, interpret=True)),
        )
    return out


@pytest.mark.parametrize("method", ["scatter", "sort", "onehot"])
@pytest.mark.parametrize("k", [4, 8, 10])
def test_dense_counts_vs_jax(jax_hists, k, method):
    codes, valid = _inputs(k)
    want, want_pallas = jax_hists[k]
    np.testing.assert_array_equal(want, want_pallas)
    table = torch.zeros(4 ** k, dtype=torch.int32)
    got = th.dense_counts(
        torch.from_numpy(codes), torch.from_numpy(valid), table, 4 ** k,
        method,
    )
    assert got is table  # accumulates in place
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [4, 8, 10])
def test_histogram_reference_vs_jax(jax_hists, k):
    codes, valid = _inputs(k)
    want, want_pallas = jax_hists[k]
    got = hk.histogram_reference(
        torch.from_numpy(codes), torch.from_numpy(valid), k
    )
    assert got.dtype == torch.int32 and got.shape == (4 ** k,)
    np.testing.assert_array_equal(got.numpy(), want_pallas)
    np.testing.assert_array_equal(
        th.histogram(torch.from_numpy(codes), torch.from_numpy(valid),
                     4 ** k).numpy(),
        want,
    )


@pytest.mark.parametrize("method", ["scatter", "sort", "onehot"])
def test_dense_counts_accumulates_int64(method):
    k = 5
    codes, valid = _inputs(k, seed=11)
    start = np.arange(4 ** k, dtype=np.int64) + (1 << 33)
    table = torch.from_numpy(start.copy())
    th.dense_counts(torch.from_numpy(codes), torch.from_numpy(valid), table,
                    4 ** k, method)
    want = start + np.bincount(codes[valid], minlength=4 ** k)
    np.testing.assert_array_equal(table.numpy(), want)


@pytest.mark.parametrize("valid_dtype", [torch.bool, torch.uint8])
def test_histogram_cuda_on_cpu_runs_the_twin(valid_dtype):
    k = 6
    codes, valid = _inputs(k, seed=3)
    before = hk.histogram_cuda.launches
    got = hk.histogram_cuda(
        torch.from_numpy(codes), torch.from_numpy(valid).to(valid_dtype), k
    )
    np.testing.assert_array_equal(
        got.numpy(), np.bincount(codes[valid], minlength=4 ** k)
    )
    assert hk.histogram_cuda.launches == before  # the twin is no launch


def test_add_counts_cuda_on_cpu_vs_jax():
    from findkmer_tpu.ops.pallas.histogram_kernel import add_counts_pallas

    k = 5
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 5, (4, 90)).astype(np.uint8)
    for canonical in (False, True):
        want = np.asarray(add_counts_pallas(
            jnp.asarray(rows), jnp.zeros(4 ** k, jnp.int32), k, canonical,
            interpret=True,
        ))
        table = torch.zeros(4 ** k, dtype=torch.int32)
        got = hk.add_counts_cuda(torch.from_numpy(rows), table, k, canonical)
        assert got is table
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad", [
    "k0", "k11", "codes_int64", "valid_int32", "shape", "strided",
])
def test_histogram_cuda_rejects_bad_input(bad):
    codes = torch.zeros((4, 10), dtype=torch.int32)
    valid = torch.ones((4, 10), dtype=torch.bool)
    k = 4
    if bad == "k0":
        k = 0
    elif bad == "k11":
        k = 11
    elif bad == "codes_int64":
        codes = codes.long()
    elif bad == "valid_int32":
        valid = valid.int()
    elif bad == "shape":
        valid = valid[:, :5]
    elif bad == "strided":
        codes, valid = codes[:, ::2], valid[:, ::2]
    with pytest.raises((ValueError, TypeError)):
        hk.histogram_cuda(codes, valid, k)


def test_histogram_cuda_shared_needs_small_k():
    codes = torch.zeros((2, 8), dtype=torch.int32)
    valid = torch.ones((2, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="shared-memory"):
        hk.histogram_cuda(codes, valid, hk.SHARED_MAX_K + 1, shared=True)
    for shared in (None, True, False):  # on the CPU every choice is the twin
        got = hk.histogram_cuda(codes, valid, 3, shared=shared)
        assert int(got[0]) == 16 and int(got.sum()) == 16


@pytest.mark.parametrize("method", ["auto", "pallas", "bogus"])
def test_dense_counts_rejects_kernel_and_unknown_names(method):
    codes, valid = _inputs(4, seed=2)
    table = torch.zeros(4 ** 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="counter.py"):
        th.dense_counts(torch.from_numpy(codes), torch.from_numpy(valid),
                        table, 4 ** 4, method)
    assert int(table.sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4, 6, 7, 8, 10])
def test_histogram_kernel_vs_twin_on_card(k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    codes, valid = _inputs(k, shape=(64, 4099))
    c = torch.from_numpy(codes).cuda()
    v = torch.from_numpy(valid).cuda()
    want = hk.histogram_reference(c, v, k)
    for shared in (True, False) if k <= hk.SHARED_MAX_K else (False,):
        before = hk.histogram_cuda.launches
        got = hk.histogram_cuda(c, v, k, shared=shared)
        torch.cuda.synchronize()
        assert hk.histogram_cuda.launches == before + 1
        assert torch.equal(got, want)
