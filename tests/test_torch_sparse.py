"""The sparse store's compaction chain of the PyTorch port vs the JAX
package, plane by plane.

The same numpy-seeded raw codes go through `findkmer_tpu.ops.compaction`
/ `ops.sparse` (as (hi, lo) uint32 planes, u16 hi for 16 <= k <= 23) and
`findkmer_torch.ops.compaction` / `ops.sparse` (one integer code).  The
JAX planes map to the port's codes as (hi << 32) | lo, the JAX sentinel
to the port's.  Codes and counts are integers: every plane must be
equal.  The row sorts run the plain version here (CPU tensors).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from findkmer_tpu.ops import compaction as jcomp
from findkmer_tpu.ops import sparse as jsparse
from findkmer_torch.ops import compaction as tcomp
from findkmer_torch.ops import sparse as tsparse
from findkmer_torch.ops.window import code_dtype, sentinel

torch.set_num_threads(1)  # six test workers share the cores

KS = [11, 15, 21, 24, 31]
G = 8


def _raw(k, n, seed):
    """n raw codes from a small pool (repeats), a fifth of them empty
    slots, the all-ones code (a poly-T k-mer) in the pool."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 4 ** k, 40, dtype=np.int64)
    pool[0] = 4 ** k - 1
    codes = pool[rng.integers(0, pool.size, n)]
    codes[rng.random(n) < 0.2] = sentinel(code_dtype(k))
    return codes


def _jax_planes(codes, k):
    """Port codes (int64 numpy, port sentinel) -> JAX planes."""
    sent = codes == sentinel(code_dtype(k))
    lo = np.where(sent, 0xFFFFFFFF, codes & 0xFFFFFFFF).astype(np.uint32)
    if k <= 15:
        return (lo,)
    hdt = jsparse.hi_dtype(k)
    hi = np.where(sent, jsparse.sent_of(hdt), codes >> 32).astype(hdt)
    return hi, lo


def _port_codes(planes, k):
    """JAX code planes -> port codes (int64 numpy)."""
    lo = np.asarray(planes[-1]).astype(np.int64)
    if len(planes) == 1:
        sent = lo == 0xFFFFFFFF
        codes = lo
    else:
        hi = np.asarray(planes[0])
        sent = hi == np.iinfo(hi.dtype).max
        codes = (hi.astype(np.int64) << 32) | lo
    return np.where(sent, sentinel(code_dtype(k)), codes)


def _jax_store(store, k):
    """(JAX planes..., cnt) of a JAX store -> (codes, cnt) numpy."""
    return _port_codes(store[:-1], k), np.asarray(store[-1])


def _assert_store(tstore, jstore, k):
    jc, jn = _jax_store(jstore, k)
    np.testing.assert_array_equal(tstore[0].numpy(), jc)
    np.testing.assert_array_equal(tstore[1].numpy(), jn)


def _tensor(codes, k):
    return torch.from_numpy(codes).to(code_dtype(k))


@pytest.mark.parametrize("k", KS)
def test_compaction_chain_vs_jax(k):
    """raw -> counted -> squeeze -> dedup -> global, plane by plane."""
    raw1 = _raw(k, G * 32, seed=k)
    # 1. first compaction, padded to 48 columns
    jstore, jd = jcomp.compact_raw_rows(
        tuple(jnp.asarray(p) for p in _jax_planes(raw1, k)), G, 48,
        cdtype=jnp.int32)
    tstore, td = tcomp.compact_raw_rows(_tensor(raw1, k), G, 48,
                                        torch.int32)
    assert tstore[0].dtype == code_dtype(k) and tstore[1].dtype == torch.int32
    _assert_store(tstore, jstore, k)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    jkeep = tuple(np.asarray(a) for a in jstore)

    # 2. count-carrying compaction with new raw codes
    raw2 = _raw(k, G * 16, seed=k + 1)
    jstore, jd = jcomp.compact_counted_rows(
        tuple(jnp.asarray(a) for a in jkeep),
        tuple(jnp.asarray(p) for p in _jax_planes(raw2, k)), G, 96)
    tstore, td = tcomp.compact_counted_rows(tstore, _tensor(raw2, k), G, 96)
    _assert_store(tstore, jstore, k)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    jkeep = tuple(np.asarray(a) for a in jstore)
    assert int(td.max()) < 96 // 2  # holes to squeeze

    # 3. squeeze the holes off the rows
    Ld = tsparse.ladder(int(td.max()), floor=16)
    jsq = jcomp.squeeze_slice_keep(tuple(jnp.asarray(a) for a in jkeep), Ld)
    tsq = tcomp.squeeze_slice(tuple(a.clone() for a in tstore), Ld)
    assert tsq[0].shape == (G, Ld)
    _assert_store(tsq, jsq, k)

    # 4. cross-row dedup: the exact distinct count
    jded, jLc, jdrows = jcomp.dedup_rows(
        tuple(jnp.asarray(a) for a in jkeep), 1, G, 16)
    tded, tLc, tdrows = tcomp.dedup_rows(tuple(a.clone() for a in tstore),
                                         1, G, 16)
    assert tLc == jLc
    _assert_store(tded, jded, k)
    np.testing.assert_array_equal(tdrows, jdrows)
    live = np.concatenate([raw1, raw2])
    live = live[live != sentinel(code_dtype(k))]
    assert int(tdrows.sum()) == np.unique(live).size

    # 5. global finalize: the distinct sorted spectrum
    if k <= 15:
        jout = jsparse.global_compact_narrow(*(jnp.asarray(a) for a in
                                               (jkeep[0], jkeep[1])))
    else:
        jout = jsparse.global_compact_wide(*(jnp.asarray(a) for a in jkeep))
    n_live = int(jout[-2])
    jcodes = _port_codes(jout[:-3], k)[:n_live]
    tcodes, tcnt = tsparse.global_compact(*tstore)
    np.testing.assert_array_equal(tcodes.numpy(), jcodes)
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jout[-3])[:n_live])
    want_codes, want_cnt = np.unique(live, return_counts=True)
    np.testing.assert_array_equal(tcodes.numpy(), want_codes)
    np.testing.assert_array_equal(tcnt.numpy(), want_cnt)


def test_row_geometry_matches_jax():
    for cap0 in (4096, 1 << 16, 3 << 20, 1 << 26, 1 << 28, 1 << 31):
        for g0 in (1, 64):
            assert tcomp.row_geometry(cap0, g0) == jcomp.row_geometry(cap0, g0)
    for n in (0, 1, 4096, 4097, 6145, 1 << 30):
        assert tsparse.ladder(n) == jsparse.ladder(n)
        assert tsparse.ladder(n, floor=64) == jsparse.ladder(n, floor=64)


@pytest.mark.parametrize("seed", [0, 1])
def test_rle_vs_jax(seed):
    rng = np.random.default_rng(seed)
    lo = np.sort(rng.integers(0, 50, (4, 300)).astype(np.uint32), axis=1)
    lo[:, -7:] = 0xFFFFFFFF  # sentinel tails
    hi = np.zeros_like(lo)
    codes = torch.from_numpy(_port_codes((lo,), 11)).to(torch.int32)
    want = np.asarray(jsparse.rle_pos_2d(jnp.asarray(hi), jnp.asarray(lo),
                                         wide=False))
    np.testing.assert_array_equal(tsparse.rle_pos_2d(codes).numpy(), want)
    cnt = rng.integers(0, 9, lo.shape).astype(np.int32)
    want = np.asarray(jsparse.rle_val_2d(jnp.asarray(hi), jnp.asarray(lo),
                                         jnp.asarray(cnt), wide=False))
    got = tsparse.rle_val_2d(codes, torch.from_numpy(cnt))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_rle_val_exact_when_the_running_sum_wraps(dtype):
    """Run totals stay exact whenever they fit the count dtype, however
    far the row's running sum goes (the JAX seg_totals contract): int32
    past 2^32, int64 past 2^64."""
    big = 2_000_000_000 if dtype == torch.int32 else (1 << 62) + 3
    codes = torch.tensor([[1, 2, 3, 4, 4, 5, sentinel(torch.int64)]])
    cnt = torch.tensor([[big, big, big, 5, 1, 7, 0]], dtype=dtype)
    got = tsparse.rle_val_2d(codes, cnt)
    assert got.tolist() == [[big, big, big, 0, 6, 7, 0]]
    assert cnt.tolist() == [[big, big, big, 5, 1, 7, 0]]  # input untouched


def test_global_compact_empty_and_all_holes():
    codes = torch.full((3, 5), sentinel(torch.int64), dtype=torch.int64)
    cnt = torch.zeros((3, 5), dtype=torch.int32)
    c, n = tsparse.global_compact(codes, cnt)
    assert c.numel() == 0 and n.numel() == 0
    codes[1, 2] = 9
    c, n = tsparse.global_compact(codes, cnt)  # a code with count 0: a hole
    assert c.numel() == 0


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_global_compact_totals_exact_when_the_running_sum_wraps(dtype):
    big = 2_000_000_000 if dtype == torch.int32 else (1 << 62) + 3
    sent = sentinel(torch.int64)
    codes = torch.tensor([[4, 1, 2, sent], [3, 4, 2, 1]])
    cnt = torch.tensor([[1, big, 2, 0], [big, 5, big - 2, 0]], dtype=dtype)
    c, n = tsparse.global_compact(codes, cnt)
    assert c.tolist() == [1, 2, 3, 4] and n.dtype == dtype
    assert n.tolist() == [big, big, big, 6]
