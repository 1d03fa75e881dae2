"""Public Python API of the port: `count`, `count_per_record`, `count_text`,
`sketch_sample` (`sketch.py`), `filter_reads` (read filtering,
`filter.py`), `matrix`, `expr`, `similarity` (the spectrum tools of
`spectra.py`) and `stream_count` (the restartable count of
`streaming.py`, re-exported).

Counterpart of the same functions of `findkmer_tpu/api.py`, with the
torch device named explicitly (`device="cuda"` or `"cpu"`, or a
`torch.device`; cuda without a card raises, as the CLI's `--device` does):

    import findkmer_torch as fkt

    spec = fkt.count(["genome.fa"], k=8, device="cuda")   # Spectrum
    spec["ACGTACGT"]                                       # -> count
    spec.to_dict(), spec.total(), spec.distinct(), spec.histo()
    fkt.count(["a.fa"], k=21, canonical=True, device="cuda").write("o.tsv")

    fkt.stream_count(["genome.fa"], fkt.Config(k=21), device="cuda",
                     checkpoint_dir="ck", checkpoint_every=64)
    fkt.filter_reads("reads.fq", "spec.tsv", "kept.fq", engine="device")
    sk = fkt.sketch_sample(["a.fa"], k=21, canonical=True, device="cuda")
    fkt.similarity(sk, "b.sketch.json")        # Mash estimate
    fkt.matrix(["a.tsv", "b.tsv"], "m.tsv", min_samples=2)
    fkt.expr("(A + B) - C", {"A": "a.tsv", "B": "b.tsv", "C": "c.tsv"})

`Spectrum` is the port's own copy of the JAX package's class, with the
same methods; its lookups use the port's window helpers.  Its spans
(`utils.prof`): `from_engine` is `finalize/assemble`, `histo` is `write`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from findkmer_torch.config import Config
from findkmer_torch.utils.prof import span


@dataclass
class Spectrum:
    """A finalized k-mer spectrum (dense or sparse backing)."""

    k: int
    canonical: bool
    _dense: Optional[np.ndarray] = None            # (4^k,) counts
    _codes: Optional[np.ndarray] = None            # sorted uint64 codes
    _counts: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    @classmethod
    def from_engine(cls, spectrum, cfg: Config) -> "Spectrum":
        with span("finalize/assemble"):
            if isinstance(spectrum, tuple):
                codes, counts = spectrum
                return cls(
                    k=cfg.k, canonical=cfg.canonical,
                    _codes=np.asarray(codes, dtype=np.uint64),
                    _counts=np.asarray(counts),
                )
            return cls(
                k=cfg.k, canonical=cfg.canonical,
                _dense=np.asarray(spectrum)
            )

    # ------------------------------------------------------------------
    def __getitem__(self, kmer: Union[str, int]) -> int:
        from findkmer_torch.ops.window import str_to_code

        code = str_to_code(kmer) if isinstance(kmer, str) else int(kmer)
        if self._dense is not None:
            return int(self._dense[code])
        i = np.searchsorted(self._codes, np.uint64(code))
        if i < self._codes.size and self._codes[i] == np.uint64(code):
            return int(self._counts[i])
        return 0

    def total(self) -> int:
        arr = self._dense if self._dense is not None else self._counts
        return int(arr.sum())

    def distinct(self) -> int:
        if self._dense is not None:
            return int(np.count_nonzero(self._dense))
        return int(self._counts.size)

    def items(self) -> Iterable[Tuple[str, int]]:
        """(kmer, count) pairs in lexicographic order, zeros skipped."""
        from findkmer_torch.ops.window import code_to_str

        if self._dense is not None:
            for code in np.nonzero(self._dense)[0]:
                yield code_to_str(int(code), self.k), int(self._dense[code])
        else:
            for code, cnt in zip(self._codes, self._counts):
                yield code_to_str(int(code), self.k), int(cnt)

    def to_dict(self) -> Dict[str, int]:
        return dict(self.items())

    def histo(self, max_count: int = 10000) -> np.ndarray:
        """Count-of-counts: h[m] = number of distinct k-mers seen m times
        (m clipped to max_count; h[0] unused)."""
        with span("write"):
            counts = (
                self._dense[self._dense > 0]
                if self._dense is not None
                else self._counts
            )
            clipped = np.minimum(counts.astype(np.int64), max_count)
            return np.bincount(clipped, minlength=max_count + 1)

    def write(self, path_or_file, *, zeros: bool = False, sep: str = "\t"):
        """Write the spectrum in CLI format (lexicographic KMER<sep>COUNT)."""
        from findkmer_torch import output as output_mod

        cfg = Config(
            k=self.k, canonical=self.canonical, zeros=zeros, sep=sep,
            table_mode="direct" if self._dense is not None else "sparse",
        )
        spectrum = (
            self._dense
            if self._dense is not None
            else (self._codes, self._counts)
        )
        if hasattr(path_or_file, "write"):
            return output_mod.write_spectrum(path_or_file, spectrum, cfg)
        with open(path_or_file, "wb") as f:
            return output_mod.write_spectrum(f, spectrum, cfg)


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

    from findkmer_torch import pipeline
    from findkmer_torch.io.fasta import FastaReader
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


def sketch_sample(
    inputs: Union[str, Sequence[str]],
    k: Optional[int] = None,
    *,
    s: int = 1000,
    canonical: bool = False,
    device: Union[str, torch.device] = "cuda",
    **config_overrides,
):
    """Bottom-s MinHash sketch (dict, sketch.SKETCH_FORMAT).

    With k: sequence input(s), counted as ONE sample like count(), on
    `device` (cuda without a card raises).  Without k: `inputs` is one
    spectrum file path (k inferred; no device work).
    CLI equivalent: `findkmer-torch sketch`."""
    from findkmer_torch import sketch as sketch_mod

    if k is not None:
        if isinstance(inputs, (str, bytes)):
            inputs = [inputs]
        return sketch_mod.sketch_sequences(
            inputs, k, s=s, canonical=canonical, device=device,
            **config_overrides
        )
    if not isinstance(inputs, (str, bytes)):
        raise ValueError("without k, pass one spectrum file path")
    return sketch_mod.sketch_spectrum_file(inputs, s=s, canonical=canonical)


def filter_reads(
    inputs: Union[str, Sequence[str]],
    spectrum: str,
    output: Union[str, Sequence[str]],
    *,
    paired: bool = False,
    min_hits: int = 1,
    min_frac: Optional[float] = None,
    invert: bool = False,
    canonical: bool = False,
    min_count: int = 0,
    max_count: int = 0,
    engine: str = "auto",
    pair_mode: str = "any",
    fmt: str = "auto",
    sep: str = "\t",
    device: Union[str, torch.device] = "cuda",
):
    """Filter reads by spectrum membership.  CLI: `findkmer-torch filter`.

    Single-end: inputs = path or list of paths, output = one path.
    Paired (paired=True): inputs = (R1, R2), output = (OUT1, OUT2);
    pairs are kept/dropped together (pair_mode "any" or "both").
    engine: "host" (OpenMP C scan) / "device" (membership on `device`,
    where cuda without a card raises) / "auto" (device on a CUDA
    `device`, host on the CPU).
    Returns (reads_or_pairs_kept, seen)."""
    from findkmer_torch.cli import filter_into  # gz by extension, as the CLI
    from findkmer_torch.filter import FilterSpec, _resolve_engine

    engine = _resolve_engine(engine, device)
    dev = _device(device) if engine == "device" else None
    spec = FilterSpec.load(
        spectrum, sep=sep, canonical=canonical,
        min_count=min_count, max_count=max_count,
    )
    opts = dict(fmt=fmt, min_hits=min_hits, min_frac=min_frac,
                invert=invert, engine=engine, device=dev,
                pair_mode=pair_mode)
    if paired:
        ins, outs = list(inputs), list(output)
        if len(ins) != 2 or len(outs) != 2:
            raise ValueError(
                "paired filtering takes inputs=(R1, R2) and "
                "output=(OUT1, OUT2)"
            )
        return filter_into(ins, outs, spec, paired=True, **opts)
    if isinstance(inputs, (str, bytes)):
        inputs = [inputs]
    return filter_into(inputs, [output], spec, **opts)


def matrix(
    inputs: Sequence[str],
    output: str,
    *,
    names: Optional[Sequence[str]] = None,
    min_total: int = 0,
    min_samples: int = 0,
    sep: str = "\t",
) -> int:
    """k-mer x sample count matrix from sorted spectrum files.
    CLI: `findkmer-torch matrix`.  Returns data rows written."""
    from findkmer_torch import spectra
    from findkmer_torch.cli import _input_stems, _open_out

    inputs = list(inputs)
    use_names = list(names) if names is not None else _input_stems(inputs)
    if len(use_names) != len(inputs):
        # validate BEFORE _open_out truncates an existing output
        raise ValueError(
            f"matrix needs one name per input ({len(inputs)} inputs, "
            f"{len(use_names)} names)"
        )
    f, close = _open_out(output)
    try:
        return spectra.matrix_sorted_streaming(
            inputs, f, use_names, sep=sep,
            min_total=min_total, min_samples=min_samples,
        )
    finally:
        if close:
            f.close()


def expr(
    expression: str,
    inputs: Dict[str, str],
    output: Optional[str] = None,
    *,
    canonical: bool = False,
    sep: str = "\t",
):
    """Set-algebra expression over sorted spectrum files.
    CLI: `findkmer-torch expr`.

    With output=None returns {kmer: count}; with an output path writes
    KMER<sep>COUNT lines (streaming, O(buffers)) and returns the line
    count."""
    from findkmer_torch import spectra

    if output is None:
        if canonical:
            names = sorted(inputs)
            with spectra._CanonizedInputs(
                [inputs[n] for n in names], sep
            ) as folded:
                return {
                    km.decode(): c
                    for km, c in spectra.eval_expression(
                        expression, dict(zip(names, folded)), sep
                    )
                }
        return {
            km.decode(): c
            for km, c in spectra.eval_expression(expression, inputs, sep)
        }
    from findkmer_torch.cli import _open_out

    f, close = _open_out(output)
    try:
        return spectra.expr_sorted_streaming(
            expression, inputs, f, sep=sep, canonical=canonical
        )
    finally:
        if close:
            f.close()


def similarity(a, b, *, canonical: bool = False, sep: str = "\t"):
    """Similarity metrics between two spectrum files, or two sketch
    dicts/files (Mash estimator).  CLI: `findkmer-torch similarity`."""
    from findkmer_torch import sketch as sketch_mod
    from findkmer_torch import spectra

    def _as_sketch(x):
        if isinstance(x, dict):
            return x
        return sketch_mod.read_sketch(x)

    a_sk = isinstance(a, dict) or (
        isinstance(a, (str, bytes)) and sketch_mod.is_sketch_file(a)
    )
    b_sk = isinstance(b, dict) or (
        isinstance(b, (str, bytes)) and sketch_mod.is_sketch_file(b)
    )
    if a_sk or b_sk:
        ref = _as_sketch(a if a_sk else b)
        if canonical and not bool(ref["canonical"]):
            # folding only the spectrum side would always fail
            # compare_sketches' mismatch guard AFTER the (potentially
            # long) sketch work — reject up front, like the CLI does
            raise ValueError(
                "canonical=True cannot apply to a non-canonical "
                f"sketch ({ref.get('name', '?')}); re-sketch it "
                "canonically or drop the flag"
            )
        sa = _as_sketch(a) if a_sk else sketch_mod.sketch_spectrum_file(
            a, s=int(ref["s"]), sep=sep,
            canonical=bool(ref["canonical"]) or canonical)
        sb = _as_sketch(b) if b_sk else sketch_mod.sketch_spectrum_file(
            b, s=int(ref["s"]), sep=sep,
            canonical=bool(ref["canonical"]) or canonical)
        return sketch_mod.compare_sketches(sa, sb)
    return spectra.similarity_spectra(a, b, sep=sep, canonical=canonical)


def stream_count(paths, cfg: Config, **kw):
    """`findkmer_torch.streaming.stream_count`: the engine's spectrum of
    `paths` (dense np counts, or sparse (codes, counts)), counted with
    optional checkpoint / resume (checkpoint_dir, checkpoint_every,
    stats, num_processes, process_id, device)."""
    from findkmer_torch import streaming

    return streaming.stream_count(paths, cfg, **kw)
