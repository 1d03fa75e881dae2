"""Window extraction of the PyTorch port vs the JAX package.

The same batches, cut by the JAX host batcher from a numpy-seeded code
stream (raw rows and 2-bit packed pairs), go through
`findkmer_tpu.ops.window` and `findkmer_torch.ops.window`.  Codes,
validity and unpacked rows are integers: they must agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from findkmer_tpu import pipeline as jax_pipeline
from findkmer_tpu.config import Config
from findkmer_tpu.ops import window as jw
from findkmer_torch.ops import window as tw

torch.set_num_threads(1)  # six test workers share the cores


def _batches(seed, k, packed, L=61, B=3, n=700):
    """JAX-batcher batches of a seeded stream with INVALID runs."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[rng.random(n) < 0.05] = 4
    codes[100:110] = 4
    cfg = Config(k=k, chunk_len=L, batch_rows=B, packed_h2d=packed)
    return cfg, list(jax_pipeline.batches_from_codes(iter([codes]), cfg))


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
    rows = torch.zeros((1, 20), dtype=torch.uint8)
    for k in (0, 16):
        with pytest.raises(ValueError):
            tw.window_codes(rows, k)


@pytest.mark.parametrize("k", [1, 5, 15])
def test_host_helpers_vs_jax(k):
    rng = np.random.default_rng(k)
    for code in rng.integers(0, 4 ** k, 20):
        code = int(code)
        assert tw.revcomp_code(code, k) == jw.revcomp_code(code, k)
        s = tw.code_to_str(code, k)
        assert s == jw.code_to_str(code, k)
        assert tw.str_to_code(s) == jw.str_to_code(s) == code
