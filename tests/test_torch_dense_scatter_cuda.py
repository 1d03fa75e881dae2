"""The dense step above the histogram kernels' k on a card: C1 and one
`index_add_` (`models/counter._c1_scatter_step`), and the `count` that
takes it past the sparse store's ceiling.

On a card (`cuda` marker, skipped here):
  * the step against the plain chain (`rows_from_batch` -> `window_codes`
    -> the trash-bin scatter of `ops/histogram.py`) at k = 11..15,
    canonical and not, on batches of the host packer with N runs,
    record ends and padded rows, so that C1's sentinel slots are many:
    the tables equal bit for bit, and C1 launched once a batch;
  * `count -k 15 --canonical --min-count 2` through `cli.main` with
    default flags on a generated chr1-like record of more than 2^28 bytes
    (the dense route), its output byte for byte the plain reference's
    (`kmerbench/reference/tsv_spectrum_min.py`) computed on the card.

This file does not import JAX, so it runs on a machine without it:
`python -m pytest --noconftest -m cuda tests/test_torch_dense_scatter_cuda.py`.
"""

import hashlib
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from findkmer_torch import cli, pipeline
from findkmer_torch.config import Config
from findkmer_torch.models import counter as counter_mod
from findkmer_torch.ops.cuda.window_codes_kernel import (
    window_codes_packed_cuda,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    return torch.device("cuda")


def _genome(path, n=3_000_000, seed=5):
    """Records of random bases with N runs and a tandem array."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    seq = acgt[rng.integers(0, 4, n)]
    seq[: 200_000] = np.tile(acgt[rng.integers(0, 4, 171)], 1200)[:200_000]
    for at in rng.integers(0, n - 70_000, 40):
        seq[at : at + int(rng.integers(1, 70_000))] = ord("N")
    with open(path, "wb") as f:
        for i, rec in enumerate(np.split(seq, [900_001, 900_050, 2_000_000])):
            f.write(f">r{i}\n".encode())
            for s in range(0, rec.size, 80):
                f.write(rec[s : s + 80].tobytes() + b"\n")


@pytest.mark.cuda
@pytest.mark.parametrize("canonical", [False, True],
                         ids=["forward", "canonical"])
@pytest.mark.parametrize("k", [11, 12, 13, 14, 15])
def test_c1_scatter_step_equals_the_plain_chain(tmp_path, k, canonical):
    dev = _card()
    path = str(tmp_path / "g.fa")
    _genome(path)
    cfg = Config(k=k, canonical=canonical, table_mode="direct",
                 batch_rows=64, chunk_len=16384)
    got = torch.zeros(4 ** k, dtype=torch.int32, device=dev)
    want = torch.zeros_like(got)
    before = window_codes_packed_cuda.launches
    batches = 0
    sentinels = 0
    for packed, bits in pipeline.batches_from_file(path, cfg):
        batch = (torch.from_numpy(packed).to(dev),
                 torch.from_numpy(bits).to(dev))
        counter_mod._c1_scatter_step(got, batch, k, canonical, cfg.row_len)
        counter_mod._dense_step(want, batch, k, canonical, 4 ** k,
                                "scatter", cfg.row_len)
        codes = window_codes_packed_cuda(*batch, k, canonical,
                                         R=cfg.row_len)
        sentinels += int((codes == torch.iinfo(torch.int32).max).sum())
        batches += 1
    assert window_codes_packed_cuda.launches - before == 2 * batches
    assert sentinels > 1_000_000
    assert torch.equal(got, want)
    assert 0 < int(got.sum()) < 3_000_000


@pytest.mark.cuda
def test_the_counter_takes_c1_above_k10_on_the_card():
    dev = _card()
    assert counter_mod.KmerCounter(Config(k=15, table_mode="direct"),
                                   dev)._method == "c1_scatter"
    assert counter_mod.KmerCounter(Config(k=10), dev)._method == "pallas"
    assert counter_mod.KmerCounter(
        Config(k=13, table_mode="direct", hist="scatter"),
        dev)._method == "scatter"


@pytest.mark.cuda
def test_count_k15_past_the_ceiling_equals_the_reference(tmp_path):
    """The deployment's route on a chr1-like record of more than 2^28
    bytes: the dense table, with default flags and no spill directory."""
    dev = _card()
    from kmerbench.gen import chr1_like, common
    from kmerbench.reference import tsv_spectrum_min

    params = json.loads((ROOT / "kmerbench" / "traffic" / "chr1.json")
                        .read_text())["params"]
    try:
        made = chr1_like.generate(str(tmp_path), 271828,
                                  {**params, "length": 268_000_000})
        (path,) = made["inputs"]
        assert os.path.getsize(path) > cli.SPARSE_CEILING
        argv = ["count", "-k", "15", "--canonical", "--min-count", "2",
                "-i", path, "-o", str(tmp_path / "out.tsv")]
        args = cli.build_parser().parse_args(argv)
        assert cli._cfg_from_args(
            args, dense_past_ceiling=True).resolved_table_mode == "direct"
        before = window_codes_packed_cuda.launches
        assert cli.main(argv) == 0
        assert window_codes_packed_cuda.launches > before
        got = hashlib.sha256()
        with open(tmp_path / "out.tsv", "rb") as f:
            for block in iter(lambda: f.read(1 << 24), b""):
                got.update(block)
        want = hashlib.sha256()
        (stream,) = tsv_spectrum_min.streams([path], 15, True, dev,
                                             min_count=2)
        for piece in stream:
            want.update(memoryview(piece))
        assert got.hexdigest() == want.hexdigest()
    finally:
        common.release()
