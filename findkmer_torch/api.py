"""Public Python API of the port: `count`, `count_per_record`, `count_text`.

Counterpart of the same functions of `findkmer_tpu/api.py`, with the
torch device named explicitly (`device="cuda"` or `"cpu"`, or a
`torch.device`; cuda without a card raises, as the CLI's `--device` does):

    import findkmer_torch as fkt

    spec = fkt.count(["genome.fa"], k=8, device="cuda")   # Spectrum
    spec["ACGTACGT"]                                       # -> count
    spec.to_dict(), spec.total(), spec.distinct(), spec.histo()
    fkt.count(["a.fa"], k=21, canonical=True, device="cuda").write("o.tsv")

The returned `Spectrum` is the JAX package's, with the two methods that
reach its jax-importing window helpers (`__getitem__`, `items`) taking
the port's instead: every method works without jax.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from findkmer_tpu.api import Spectrum as _Spectrum
from findkmer_tpu.config import Config


class Spectrum(_Spectrum):
    """A finalized k-mer spectrum (dense or sparse backing)."""

    def __getitem__(self, kmer: Union[str, int]) -> int:
        from findkmer_torch.ops.window import str_to_code

        code = str_to_code(kmer) if isinstance(kmer, str) else int(kmer)
        if self._dense is not None:
            return int(self._dense[code])
        i = np.searchsorted(self._codes, np.uint64(code))
        if i < self._codes.size and self._codes[i] == np.uint64(code):
            return int(self._counts[i])
        return 0

    def items(self) -> Iterable[Tuple[str, int]]:
        """(kmer, count) pairs in lexicographic order, zeros skipped."""
        from findkmer_torch.ops.window import code_to_str

        if self._dense is not None:
            for code in np.nonzero(self._dense)[0]:
                yield code_to_str(int(code), self.k), int(self._dense[code])
        else:
            for code, cnt in zip(self._codes, self._counts):
                yield code_to_str(int(code), self.k), int(cnt)


def _device(device) -> torch.device:
    from findkmer_torch.device import resolve_device

    if isinstance(device, str):
        return resolve_device(device)
    return torch.device(device)


def _config(k: int, canonical: Optional[bool], config: Optional[Config],
            overrides: dict) -> Config:
    cfg = config or Config(k=k)
    if canonical is not None:
        overrides["canonical"] = canonical
    return cfg.replace(k=k, **overrides)


def count(
    inputs: Union[str, Sequence[str]],
    k: int,
    *,
    canonical: Optional[bool] = None,
    config: Optional[Config] = None,
    device: Union[str, torch.device] = "cuda",
    **config_overrides,
) -> Spectrum:
    """Count k-mers in FASTA/FASTQ file(s), counted as one input, on
    `device`; returns a Spectrum.

    Extra keyword arguments become Config fields (e.g. chunk_len=...,
    table_mode="sparse", hist="scatter").  canonical=None (the default)
    keeps config's setting."""
    from findkmer_torch import pipeline

    if isinstance(inputs, (str, bytes)):
        inputs = [inputs]
    cfg = _config(k, canonical, config, config_overrides)
    return Spectrum.from_engine(
        pipeline.count_file(list(inputs), cfg, _device(device)), cfg)


def count_per_record(
    inputs: Union[str, Sequence[str]],
    k: int,
    *,
    canonical: Optional[bool] = None,
    config: Optional[Config] = None,
    device: Union[str, torch.device] = "cuda",
    **config_overrides,
):
    """Yield (header, Spectrum) per FASTA record / FASTQ read, counted on
    `device` (`pipeline.per_record_spectra`).  CLI equivalent:
    `count --per-record`.  canonical=None (the default) keeps config's
    setting."""
    from findkmer_torch import pipeline

    if isinstance(inputs, (str, bytes)):
        inputs = [inputs]
    cfg = _config(k, canonical, config, config_overrides)
    dev = _device(device)
    for path in inputs:
        for header, spectrum in pipeline.per_record_spectra(path, cfg, dev):
            yield header, Spectrum.from_engine(spectrum, cfg)


def count_text(text: str, k: int, *,
               device: Union[str, torch.device] = "cuda", **kw) -> Spectrum:
    """Count k-mers in in-memory FASTA text on `device` (convenience for
    small data)."""
    import io

    from findkmer_tpu.io.fasta import FastaReader
    from findkmer_torch import pipeline
    from findkmer_torch.models.counter import KmerCounter

    cfg = Config(k=k, **kw)
    counter = KmerCounter(cfg, _device(device))
    state = counter.init_state()
    reader = FastaReader(io.BytesIO(text.encode()))
    for rows in pipeline.batches_from_codes(
        pipeline.code_stream(reader, prefer_native=False), cfg
    ):
        state = counter.step(state, counter.put_batch(rows))
    return Spectrum.from_engine(counter.finalize(state), cfg)
