"""Window extraction of the PyTorch port vs the JAX package.

The same batches, cut by the JAX host batcher from a numpy-seeded code
stream (raw rows and 2-bit packed pairs), go through
`findkmer_tpu.ops.window` and `findkmer_torch.ops.window`.  Codes,
validity and unpacked rows are integers: they must agree exactly.
"""

import jax.numpy as jnp
import dataclasses

import numpy as np
import pytest
import torch

from findkmer_tpu import pipeline as jax_pipeline
from findkmer_tpu.config import Config as JaxConfig
from findkmer_tpu.ops import window as jw
from findkmer_torch import Config
from findkmer_torch.ops import window as tw
from findkmer_torch.ops.cuda import window_codes_kernel as wck

SPARSE_KS = [11, 15, 16, 21, 23, 24, 28, 29, 31]
JAX_SENT = 0xFFFFFFFF

torch.set_num_threads(1)  # six test workers share the cores


def _jax(cfg):
    """The JAX package's Config with the same fields."""
    return JaxConfig(**dataclasses.asdict(cfg))


def _batches(seed, k, packed, L=61, B=3, n=700):
    """JAX-batcher batches of a seeded stream with INVALID runs."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[rng.random(n) < 0.05] = 4
    codes[100:110] = 4
    cfg = Config(k=k, chunk_len=L, batch_rows=B, packed_h2d=packed)
    return cfg, list(jax_pipeline.batches_from_codes(iter([codes]), _jax(cfg)))


def _as_torch(batch):
    if isinstance(batch, tuple):
        return tuple(torch.from_numpy(a) for a in batch)
    return torch.from_numpy(batch)


def _as_jax(batch):
    if isinstance(batch, tuple):
        return tuple(jnp.asarray(a) for a in batch)
    return jnp.asarray(batch)


@pytest.mark.parametrize("packed", [False, True], ids=["raw", "packed"])
@pytest.mark.parametrize("canonical", [False, True], ids=["fwd", "canon"])
@pytest.mark.parametrize("k", range(1, 16))
def test_window_codes_vs_jax(k, canonical, packed):
    cfg, batches = _batches(k, k, packed)
    assert len(batches) > 1
    R = cfg.row_len
    for b in batches:
        jrows = np.asarray(jw.rows_from_batch(_as_jax(b), R))
        trows = tw.rows_from_batch(_as_torch(b), R)
        np.testing.assert_array_equal(trows.numpy(), jrows)
        jc, jv = jw.window_codes(jnp.asarray(jrows), k, canonical)
        tc, tv = tw.window_codes(trows, k, canonical)
        assert tc.dtype == torch.int32 and tv.dtype == torch.bool
        jv = np.asarray(jv)
        np.testing.assert_array_equal(tv.numpy(), jv)
        np.testing.assert_array_equal(
            np.where(jv, np.asarray(jc), -1), torch.where(tv, tc, -1).numpy()
        )


@pytest.mark.parametrize("R", [1, 7, 8, 9, 64, 131])
def test_unpack_rows_vs_jax(R):
    rng = np.random.default_rng(R)
    R8 = (R + 7) // 8 * 8
    packed = rng.integers(0, 256, (5, R8 // 4)).astype(np.uint8)
    validbits = rng.integers(0, 256, (5, R8 // 8)).astype(np.uint8)
    want = np.asarray(
        jw.unpack_rows(jnp.asarray(packed), jnp.asarray(validbits), R)
    )
    got = tw.unpack_rows(
        torch.from_numpy(packed), torch.from_numpy(validbits), R
    )
    assert got.dtype == torch.uint8 and got.shape == (5, R)
    np.testing.assert_array_equal(got.numpy(), want)


def test_window_codes_rejects_bad_k():
    rows = torch.zeros((1, 40), dtype=torch.uint8)
    for k in (0, 32):
        with pytest.raises(ValueError):
            tw.window_codes(rows, k)
        with pytest.raises(ValueError):
            tw.window_codes_packed(rows, rows, k)


@pytest.mark.parametrize("k", [1, 5, 15])
def test_host_helpers_vs_jax(k):
    rng = np.random.default_rng(k)
    for code in rng.integers(0, 4 ** k, 20):
        code = int(code)
        assert tw.revcomp_code(code, k) == jw.revcomp_code(code, k)
        s = tw.code_to_str(code, k)
        assert s == jw.code_to_str(code, k)
        assert tw.str_to_code(s) == jw.str_to_code(s) == code


def _jax_codes(hi, lo, k):
    """JAX (hi, lo) code planes (hi None for k <= 15) as the port's
    integer codes, the JAX sentinel mapped to the port's."""
    lo = np.asarray(lo).astype(np.int64)
    if hi is None:
        return np.where(lo == JAX_SENT, tw.sentinel(tw.code_dtype(k)), lo)
    hi = np.asarray(hi)
    sent = hi == np.iinfo(hi.dtype).max
    hi = hi.astype(np.int64)
    return np.where(sent, tw.sentinel(torch.int64), (hi << 32) | lo)


@pytest.mark.parametrize("canonical", [False, True], ids=["fwd", "canon"])
@pytest.mark.parametrize("k", SPARSE_KS)
def test_window_codes_wide_k_vs_jax(k, canonical):
    """Raw rows: the port's one-integer codes against the JAX int32 codes
    (k <= 15) or (hi, lo) pairs (window_codes_wide), window by window."""
    cfg, batches = _batches(k, k, packed=False, n=900)
    assert len(batches) > 1
    for b in batches:
        tc, tv = tw.window_codes(torch.from_numpy(b), k, canonical)
        assert tc.dtype == tw.code_dtype(k)
        if k <= 15:
            jc, jv = jw.window_codes(jnp.asarray(b), k, canonical)
            want = np.asarray(jc).astype(np.int64)
        else:
            jhi, jlo, jv = jw.window_codes_wide(jnp.asarray(b), k, canonical)
            want = _jax_codes(jhi, jlo, k)
        jv = np.asarray(jv)
        np.testing.assert_array_equal(tv.numpy(), jv)
        np.testing.assert_array_equal(tc.numpy()[jv], want[jv])
        assert jv.any() and not jv.all()


# the plain version, and C1's wrapper (on CPU tensors: its plain version)
PACKED_ENTRIES = {"plain": tw.window_codes_packed,
                  "wrapper": wck.window_codes_packed_cuda}


@pytest.mark.parametrize("entry", list(PACKED_ENTRIES))
@pytest.mark.parametrize("canonical", [False, True], ids=["fwd", "canon"])
@pytest.mark.parametrize("k", SPARSE_KS)
def test_window_codes_packed_vs_jax(k, canonical, entry):
    """Packed rows: the same slots in the same order, the sorted valid
    codes equal, and equal to the raw-row extraction's valid codes; by the
    plain version and by C1's wrapper alike."""
    extract = PACKED_ENTRIES[entry]
    cfg, batches = _batches(k + 100, k, packed=True, n=900)
    assert len(batches) > 1
    R = cfg.row_len
    for packed, validbits in batches:
        tp, tvb = torch.from_numpy(packed), torch.from_numpy(validbits)
        got = extract(tp, tvb, k, canonical, R=R)
        assert got.dtype == tw.code_dtype(k)
        assert got.shape == (tw.packed_slots(*packed.shape, k, R),)
        planes = jw.window_codes_packed(jnp.asarray(packed),
                                        jnp.asarray(validbits), k,
                                        canonical, R=R)
        want = _jax_codes(None if k <= 15 else planes[0], planes[-1], k)
        np.testing.assert_array_equal(got.numpy(), want)
        sent = tw.sentinel(tw.code_dtype(k))
        rc, rv = tw.window_codes(tw.unpack_rows(tp, tvb, R), k, canonical)
        np.testing.assert_array_equal(
            np.sort(got.numpy()[got.numpy() != sent]), np.sort(rc[rv].numpy())
        )
        # `out` fills a slice of a larger buffer in place
        buf = torch.full((got.numel() + 5,), -1, dtype=got.dtype)
        extract(tp, tvb, k, canonical, R=R, out=buf[2 : 2 + got.numel()])
        assert torch.equal(buf[2 : 2 + got.numel()], got)
        assert int(buf[0]) == int(buf[-1]) == -1


def test_window_codes_packed_checks_out():
    packed = torch.zeros((2, 8), dtype=torch.uint8)
    n = tw.packed_slots(2, 8, 21, 30)
    with pytest.raises(ValueError, match="out must be"):
        tw.window_codes_packed(packed, packed[:, :4], 21, R=30,
                               out=torch.empty(n, dtype=torch.int32))
    with pytest.raises(ValueError, match="out must be"):
        tw.window_codes_packed(packed, packed[:, :4], 21, R=30,
                               out=torch.empty(n + 1, dtype=torch.int64))


def test_poly_t_codes_stay_below_the_sentinel():
    """A run of T's: every code of the run is 4^k - 1 (all ones, the JAX
    lo = 0xFFFFFFFF case at k >= 16), real and distinct from the
    sentinel."""
    for k in (16, 21, 31):
        rows = torch.full((1, 3 * k), 3, dtype=torch.uint8)
        codes, valid = tw.window_codes(rows, k)
        assert bool(valid.all())
        assert bool((codes == 4 ** k - 1).all())
        assert 4 ** k - 1 < tw.sentinel(tw.code_dtype(k))
