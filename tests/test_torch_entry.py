"""The port's compile-check entry points against the reference's, on the
CPU: `KmerCounter.jitted_forward` (findkmer_tpu/models/counter.py) and
`findkmer_torch/graft_entry.py` (the repository's `__graft_entry__.py`).

The same example arguments and the same numpy-seeded rows go through the
reference's `fn` and the port's.  Dense tables must be equal; a sparse
store must be equal slot for slot once the reference's (hi, lo) planes
are joined into one code and its all-ones sentinel mapped to the port's
(the dtype's max).  Integers: equality is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from findkmer_tpu.config import Config as JaxConfig
from findkmer_tpu.models.counter import KmerCounter as JaxCounter
from findkmer_tpu.ops import sparse as jax_sparse
from findkmer_torch import Config
from findkmer_torch.graft_entry import dryrun_multichip, entry
from findkmer_torch.models.counter import KmerCounter
from findkmer_torch.ops.window import sentinel
from findkmer_torch.parallel.dryrun import LEGS

torch.set_num_threads(1)  # six test workers share the cores

CPU = torch.device("cpu")
GEOM = dict(batch_rows=8, chunk_len=256)


def _rows(shape, seed=0):
    """Seeded uint8 code rows: 0..3, ~5% 4 (N)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 4, shape, dtype=np.uint8)
    rows[rng.random(shape) < 0.05] = 4
    return rows


def _pair(k, canonical):
    cfg = dict(k=k, canonical=canonical, **GEOM)
    return (JaxCounter(JaxConfig(**cfg)).jitted_forward(),
            KmerCounter(Config(**cfg), CPU).jitted_forward())


def _joined(store, k):
    """The reference's store planes -> (codes as the port's dtype, with
    the port's sentinel; counts)."""
    *planes, cnt = (np.asarray(p) for p in store)
    if len(planes) == 1:
        (lo,) = planes
        sent = lo == jax_sparse.SENTINEL
        codes = lo.astype(np.int64)
    else:
        hi, lo = planes
        sent = hi == jax_sparse.sent_of(hi.dtype)
        codes = (hi.astype(np.int64) << 32) | lo.astype(np.int64)
    dt = torch.int32 if k <= 15 else torch.int64
    codes[sent] = sentinel(dt)
    return codes, cnt


@pytest.mark.parametrize("k, canonical", [(4, False), (8, False), (8, True)],
                         ids=["k4", "k8", "k8_canonical"])
def test_dense_jitted_forward_equals_reference(k, canonical):
    (jfn, (jtable, jrows)), (fn, (table, rows)) = _pair(k, canonical)
    assert rows.dtype == torch.uint8 and rows.device == CPU
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable))
    assert table.dtype == torch.int32
    # the reference's step donates its table: a fresh one a call
    zeros = np.zeros(jtable.shape, jtable.dtype)
    got = fn(table.clone(), rows)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfn(jtable,
                                                              jrows)))
    assert int(got.sum()) == 0  # all-N rows: no valid window
    seeded = _rows(tuple(rows.shape))
    got = fn(torch.zeros_like(table), torch.from_numpy(seeded))
    want = np.asarray(jfn(jnp.asarray(zeros), seeded))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(want.sum()) > 0


@pytest.mark.parametrize("k, canonical", [(11, False), (21, False),
                                          (21, True)],
                         ids=["k11", "k21", "k21_canonical"])
def test_sparse_jitted_forward_equals_reference(k, canonical):
    (jfn, (jrows,)), (fn, (rows,)) = _pair(k, canonical)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    for batch in (rows.numpy(), _rows(tuple(rows.shape), seed=k)):
        (codes, cnt), d = fn(torch.from_numpy(batch.copy()))
        jstore, jd = jfn(batch)
        want_codes, want_cnt = _joined(jstore, k)
        assert codes.shape == want_codes.shape
        np.testing.assert_array_equal(codes.numpy(), want_codes)
        np.testing.assert_array_equal(cnt.numpy(), want_cnt)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


def test_entry_equals_reference():
    """entry(device="cpu") against __graft_entry__.entry(): the k=8
    dense step at 64 x 1024."""
    jfn, (jtable, jrows) = jax_entry.entry()
    fn, (table, rows) = entry(device="cpu")
    assert tuple(rows.shape) == tuple(jrows.shape) == (64, 1024 + 7)
    assert tuple(table.shape) == tuple(jtable.shape) == (4 ** 8,)
    zeros = np.zeros(jtable.shape, jtable.dtype)
    seeded = _rows(tuple(rows.shape), seed=8)
    for batch in (rows, torch.from_numpy(seeded)):
        got = fn(torch.zeros_like(table), batch)
        # the reference's step donates its table: a fresh one a call
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jfn(jnp.asarray(zeros), batch.numpy())))


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_cpu(n):
    """Every leg over n CPU shards, each held exactly to its numpy
    reference inside; the spill leg wrote a run a shard at least."""
    records = dryrun_multichip(n, device="cpu")
    assert list(records) == list(LEGS)
    assert all(r["equal"] and r["shards"] == n for r in records.values())
    assert records["spill"]["spill_runs"] >= n
    assert records["all_to_all"]["k"] == 8
    assert records["psum"]["k"] == 4 and records["dp_sparse"]["k"] == 21
