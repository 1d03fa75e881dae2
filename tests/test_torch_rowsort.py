"""K3, the row sort of the sparse store: its plain version, its wrapper
on the CPU, and the kernel's compare-exchange network.

The kernel itself runs only on a CUDA card (the `cuda` tests at the end;
`chip_smoke.py` holds it against the plain version at the production
shapes).  Here its network is replayed in numpy, stage by stage with the
index arithmetic of `csrc/rowsort.cu`, including the slots past C that
act as +infinity; keys are integers, so every check is exact.
"""

import numpy as np
import pytest
import torch

from findkmer_torch.ops.cuda import rowsort_kernel as rk

torch.set_num_threads(1)  # six test workers share the cores

SHAPES = [(3, 1000), (64, 64), (5, 1), (4, 2), (7, 33), (2, 1537)]


def _keys(shape, dtype, case, seed=0):
    rng = np.random.default_rng(seed)
    G, C = shape
    mx = np.iinfo(dtype).max
    if case == "random":
        return rng.integers(0, 50, shape).astype(dtype)  # many ties
    if case == "equal":
        return np.full(shape, 7, dtype)
    if case == "sentinel":
        return np.full(shape, mx, dtype)
    if case == "sorted":
        return np.tile(np.arange(C, dtype=dtype), (G, 1))
    if case == "reversed":
        return np.tile(np.arange(C, 0, -1).astype(dtype), (G, 1))
    keys = rng.integers(-(1 << 20), 1 << 20, shape).astype(dtype)
    keys[rng.random(shape) < 0.3] = mx  # "mixed": negatives and sentinels
    return keys


CASES = ["random", "equal", "sentinel", "sorted", "reversed", "mixed"]


def _pairs_equal(k1, v1, k2, v2):
    """Same keys row by row, and the same (key, val) multiset per row."""
    np.testing.assert_array_equal(k1, k2)
    for r in range(k1.shape[0]):
        a = sorted(zip(k1[r].tolist(), v1[r].tolist()))
        b = sorted(zip(k2[r].tolist(), v2[r].tolist()))
        assert a == b


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kd", [np.int32, np.int64])
def test_sort_rows_reference_vs_numpy(kd, case):
    for shape in SHAPES:
        keys = _keys(shape, kd, case)
        vals = np.arange(keys.size, dtype=np.int64).reshape(shape)
        gk, gv = rk.sort_rows_reference(torch.from_numpy(keys),
                                        torch.from_numpy(vals))
        order = np.argsort(keys, axis=1, kind="stable")
        _pairs_equal(gk.numpy(), gv.numpy(), np.sort(keys, axis=1),
                     np.take_along_axis(vals, order, 1))
        k_only, none = rk.sort_rows_reference(torch.from_numpy(keys))
        assert none is None
        np.testing.assert_array_equal(k_only.numpy(), np.sort(keys, axis=1))


def _network(keys, vals):
    """The kernel's stages in order, in numpy, on copies.

    Merge size s: a flip stage (i against its mirror in the s-block),
    then half-cleaners at strides s/4 .. 1; smaller key to the lower
    index; pairs reaching past C skipped.  A row longer than the shared
    tile runs the same stages in the same order (strides >= tile as
    global passes, the rest in the tile kernel).  Within one stage the
    pairs are disjoint, so a stage applies as one vector step."""
    keys, vals = keys.copy(), vals.copy()
    G, C = keys.shape
    P = 1 << max(C - 1, 0).bit_length()
    t = np.arange(P // 2)
    stages = []

    def flip(size):
        h = size // 2
        base = (t // h) * size
        return base + (t & (h - 1)), base + size - 1 - (t & (h - 1))

    def half(j):
        i = 2 * t - (t & (j - 1))
        return i, i + j

    size = 2
    while size <= P:
        stages.append(flip(size))
        j = size // 4
        while j >= 1:
            stages.append(half(j))
            j //= 2
        size *= 2
    for i, p in stages:
        m = p < C
        i, p = i[m], p[m]
        a, b = keys[:, i], keys[:, p]
        swap = b < a
        keys[:, i], keys[:, p] = np.where(swap, b, a), np.where(swap, a, b)
        va, vb = vals[:, i], vals[:, p]
        vals[:, i], vals[:, p] = np.where(swap, vb, va), np.where(swap, va, vb)
    return keys, vals


@pytest.mark.parametrize("case", CASES)
def test_kernel_network_sorts_any_length(case):
    for shape in SHAPES + [(1, 4097), (3, 300)]:
        keys = _keys(shape, np.int64, case, seed=shape[1])
        vals = np.arange(keys.size, dtype=np.int64).reshape(shape)
        gk, gv = _network(keys, vals)
        _pairs_equal(gk, gv, np.sort(keys, axis=1),
                     np.take_along_axis(vals, np.argsort(keys, axis=1), 1))


@pytest.mark.parametrize("vd", [None, torch.int32, torch.int64])
@pytest.mark.parametrize("kd", [torch.int32, torch.int64])
def test_sort_rows_cuda_on_cpu_runs_the_plain_version_in_place(kd, vd):
    keys = torch.from_numpy(_keys((6, 77), np.int64, "mixed")).to(kd)
    vals = None if vd is None else torch.arange(keys.numel(),
                                                dtype=vd).reshape(6, 77)
    wk, wv = rk.sort_rows_reference(keys, vals)
    before = rk.sort_rows_cuda.launches
    k2, v2 = keys.clone(), None if vals is None else vals.clone()
    gk, gv = rk.sort_rows_cuda(k2, v2)
    assert gk is k2 and gv is v2  # in place, as the kernel sorts
    assert rk.sort_rows_cuda.launches == before  # the plain version is no launch
    assert torch.equal(gk, wk)
    if vals is not None:
        assert torch.equal(gv, wv)
    # sort_rows: the wrapper, or with plain=True new tensors
    k3 = keys.clone()
    pk, _ = rk.sort_rows(k3, plain=True)
    assert torch.equal(pk, wk) and torch.equal(k3, keys)
    assert rk.sort_rows(k3)[0] is k3 and torch.equal(k3, wk)


@pytest.mark.parametrize("bad", [
    "1d", "float", "strided", "val_shape", "val_float", "val_strided",
])
def test_sort_rows_rejects_bad_input(bad):
    keys = torch.zeros((4, 10), dtype=torch.int64)
    vals = torch.zeros((4, 10), dtype=torch.int32)
    if bad == "1d":
        keys = keys.reshape(-1)
    elif bad == "float":
        keys = keys.float()
    elif bad == "strided":
        keys = keys[:, ::2]
    elif bad == "val_shape":
        vals = vals[:, :5]
    elif bad == "val_float":
        vals = vals.float()
    elif bad == "val_strided":
        vals = torch.zeros((4, 20), dtype=torch.int32)[:, ::2]
    for plain in (False, True):
        with pytest.raises((ValueError, TypeError)):
            rk.sort_rows(keys, vals, plain=plain)


@pytest.mark.cuda
@pytest.mark.parametrize("vd", [None, torch.int32, torch.int64])
@pytest.mark.parametrize("kd", [torch.int32, torch.int64])
def test_sort_rows_kernel_vs_plain_on_card(kd, vd):
    """The kernel against the plain version, exact, on every case and on
    a row long enough for the global passes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    for shape in SHAPES + [(1, 1 << 18)]:
        for case in CASES:
            nd = np.int32 if kd == torch.int32 else np.int64
            keys = torch.from_numpy(_keys(shape, nd, case)).cuda()
            vals = None if vd is None else torch.randint(
                0, 1 << 30, shape, dtype=vd, device="cuda")
            wk, wv = rk.sort_rows_reference(keys, vals)
            before = rk.sort_rows_cuda.launches
            gk, gv = rk.sort_rows_cuda(keys.clone(),
                                       None if vals is None else vals.clone())
            torch.cuda.synchronize()
            assert rk.sort_rows_cuda.launches == before + 1
            assert torch.equal(gk, wk)
            if vals is not None:
                assert torch.equal(_vals_by_pair(gk, gv), _vals_by_pair(wk, wv))


def _vals_by_pair(keys, vals):
    """vals of each row ordered by (key, val): two stable sorts.  Equal
    results mean equal (key, val) multisets per row."""
    o = torch.sort(vals, dim=1, stable=True).indices
    o = o.gather(1, torch.sort(keys.gather(1, o), dim=1, stable=True).indices)
    return vals.gather(1, o)
