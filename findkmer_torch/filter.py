"""Read filtering by spectrum membership (kmc_tools `filter` class).

The port's copy of `findkmer_tpu/filter.py`, with the same outputs.
`findkmer-torch filter` keeps (or drops, --invert) reads whose k-mers hit
a spectrum: a read passes when at least `min_hits` of its valid k-mer
windows (and, with `min_frac`, that fraction of them) are present in the
given spectrum file.

Two interchangeable scoring engines (filter_file `engine=`):
  * host: the OpenMP C scan (src/native/encode.c fk_filter_hits): codes
    by rolling shift-or, a one-probe bit-table prefilter, exact binary
    search on the survivors; numpy where the C library is not built.
  * device: `filter_device.DeviceFilter` on a torch device: the counting
    path's packed wire and window extraction, then membership by
    `torch.searchsorted` into the spectrum's codes, one hit bit a window.
Both give the same per-read (hits, valid windows), so the outputs are
byte-identical; `auto` picks the device engine on a CUDA device
(`_resolve_engine`).  FASTQ quality lines are preserved verbatim on output.
"""

from __future__ import annotations

import os
from collections import deque
from dataclasses import dataclass, field
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from findkmer_torch import spectra as _spectra
from findkmer_torch.io import native
from findkmer_torch.io.fasta import FastaReader, open_maybe_gzip
from findkmer_torch.io.fastq import sniff_format
from findkmer_torch.output import revcomp_codes_u64
from findkmer_torch.pipeline import _fastq_blocks

_CODE_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE_LUT[_b] = _i
    _CODE_LUT[_b + 32] = _i  # lowercase


def window_codes_host(seq: bytes, k: int):
    """(codes u64, valid bool) for every window of one sequence.

    codes[i] covers seq[i:i+k]; valid[i] is False when any base in the
    window is non-ACGT.  Vectorized shift-or (O(k) numpy passes)."""
    b = _CODE_LUT[np.frombuffer(seq, dtype=np.uint8)]
    n = b.size - k + 1
    if n <= 0:
        return np.empty(0, np.uint64), np.empty(0, bool)
    cbad = _cumsum01(b == 255)
    valid = cbad[k:] == cbad[:-k]  # flat monotone prefix = no bad base
    safe = np.where(b == 255, 0, b).astype(np.uint64)
    codes = np.zeros(n, np.uint64)
    for j in range(k):
        codes |= safe[j : j + n] << np.uint64(2 * (k - 1 - j))
    return codes, valid


_HASH_MULT = np.uint64(0x9E3779B97F4A7C15)


def _cumsum01(flags: np.ndarray) -> np.ndarray:
    """[0, cumsum(flags)] with the narrowest safe dtype, one buffer.

    flags is 0/1 per window; a flush holds ~16.7M windows, so an int32
    prefix sum halves the freshly allocated bytes of an int64 one."""
    dt = np.int32 if flags.size < 2**31 - 1 else np.int64
    out = np.empty(flags.size + 1, dt)
    out[0] = 0
    np.cumsum(flags, dtype=dt, out=out[1:])
    return out


def _read_spans(seqs, hit: np.ndarray, valid: np.ndarray, k: int):
    """Per-read (hits, valid windows) from per-window hit/valid arrays
    of the 'N'-joined stream (window i starts at joined position i).

    Shared by the host scorer and the device scorer (filter_device.py) so
    the two engines attribute identically."""
    n = len(seqs)
    hits = np.zeros(n, np.int64)
    windows = np.zeros(n, np.int64)
    size = int(valid.size)
    lens = np.fromiter((len(s) for s in seqs), np.int64, n)
    starts = np.zeros(n, np.int64)
    np.cumsum(lens[:-1] + 1, out=starts[1:])  # +1: the separator
    bounds = np.minimum(starts, size)
    seg = np.append(bounds, size)
    cv = _cumsum01(valid)
    ch = _cumsum01(hit)
    # windows starting within read i occupy [bounds[i], end_i) where
    # end_i = min(starts[i] + len_i, next bound)
    ends = np.minimum(np.minimum(starts + lens, seg[1:]), size)
    ends = np.maximum(ends, bounds)
    windows[:] = cv[ends] - cv[bounds]
    hits[:] = ch[ends] - ch[bounds]
    return hits, windows


@dataclass
class FilterSpec:
    """A loaded spectrum as a membership set (sorted u64 codes).

    The host engine's lookups go through a one-probe bit-table prefilter
    (>= 32 bits per entry, Fibonacci-hashed): a window that misses, the
    common case when filtering reads against a foreign spectrum, costs one
    vectorized gather; only prefilter survivors (true hits + <3% false
    positives) reach the exact searchsorted.  The table is built at the
    host engine's first lookup (`prefilter`): the device engine never
    reads it (2^28 bools, 268 MB, from 4.2 M codes up)."""

    k: int
    codes: np.ndarray  # sorted uint64
    canonical: bool = False
    _bloom: Optional[np.ndarray] = field(default=None, init=False,
                                         repr=False)  # bool bit table
    _shift: int = field(default=0, init=False, repr=False)

    def prefilter(self) -> Tuple[np.ndarray, int]:
        """(bit table, hash shift) of the host engine's prefilter, built
        on the first call."""
        if self._bloom is None:
            bits = 20
            while (1 << bits) < 32 * max(int(self.codes.size), 1):
                bits += 1
            bits = min(bits, 28)
            self._shift = 64 - bits
            bloom = np.zeros(1 << bits, bool)
            if self.codes.size:
                bloom[
                    ((self.codes * _HASH_MULT) >> np.uint64(self._shift))
                    .astype(np.int64)
                ] = True
            self._bloom = bloom
        return self._bloom, self._shift

    @classmethod
    def load(cls, path, sep: str = "\t", canonical: bool = False,
             min_count: int = 0, max_count: int = 0) -> "FilterSpec":
        sep_b = sep.encode()
        k = _spectra._infer_k(path, sep_b)
        if k is None:
            raise ValueError(f"{path}: empty or malformed spectrum")
        parsed = (
            _spectra._parse_binary(path, k, sep_b)
            if len(sep_b) == 1 else None
        )
        if parsed is None:
            from findkmer_torch.ops.window import str_to_code

            d = _spectra.read_spectrum(path, sep)
            try:
                codes = np.fromiter(
                    (str_to_code(km) for km in d), np.uint64, len(d)
                )
            except KeyError as e:
                raise ValueError(
                    f"{path}: non-ACGT k-mer in spectrum: {e}"
                ) from e
            counts = np.fromiter(d.values(), np.int64, len(d))
        else:
            codes, counts = parsed
        m = counts > 0
        codes, counts = codes[m], counts[m]
        if canonical:
            # fold BEFORE thresholding: a revcomp pair's counts sum in
            # canonical space, and the threshold must see the sum
            codes, counts = _spectra.canonize_runs(codes, counts, k)
        m = np.ones(codes.size, bool)
        if min_count > 1:
            m &= counts >= min_count
        if max_count:
            m &= counts <= max_count
        codes = np.sort(codes[m])
        return cls(k=k, codes=codes, canonical=canonical)

    def hits(self, seq: bytes) -> Tuple[int, int]:
        """(hit windows, valid windows) of one read against the set."""
        h, w = self.hits_batch([seq])
        return int(h[0]), int(w[0])

    def hits_batch(self, seqs) -> Tuple[np.ndarray, np.ndarray]:
        """Per-read (hits, valid windows) for a LIST of reads, in one
        vectorized pass: reads are joined with a single 'N' separator,
        so windows spanning read boundaries are invalid by the normal
        masking rule (the counting pipeline's record isolation).  Uses
        the OpenMP C scan when built; numpy otherwise."""
        k = self.k
        n = len(seqs)
        hits = np.zeros(n, np.int64)
        windows = np.zeros(n, np.int64)
        if n == 0:
            return hits, windows
        if native.available():
            lens = np.fromiter((len(s) for s in seqs), np.int64, n)
            starts = np.zeros(n, np.int64)
            np.cumsum(lens[:-1] + 1, out=starts[1:])  # +1: separator
            buf = np.frombuffer(b"N".join(seqs), np.uint8)
            return native.filter_hits(
                buf, starts, lens, k, self.canonical, self.codes,
                *self.prefilter(),
            )
        joined = b"N".join(seqs)
        codes, valid = window_codes_host(joined, k)
        if codes.size == 0:
            return hits, windows
        if self.canonical:
            codes = np.minimum(codes, revcomp_codes_u64(codes, k))
        hit = np.zeros(codes.size, bool)
        if self.codes.size:
            bloom, shift = self.prefilter()
            maybe = bloom[
                ((codes * _HASH_MULT) >> np.uint64(shift)).astype(np.int64)
            ]
            maybe &= valid
            cand = codes[maybe]
            if cand.size:
                idx = np.searchsorted(self.codes, cand)
                np.clip(idx, 0, self.codes.size - 1, out=idx)
                hit[maybe] = self.codes[idx] == cand
        # read i's windows START in [starts[i], starts[i] + len_i);
        # spanning windows are already invalid via the 'N' separator
        return _read_spans(seqs, hit, valid, k)


def _fastq_records_block(path) -> Iterator[Tuple[bytes, bytes]]:
    """(seq, verbatim record bytes) per FASTQ read, block-parsed.

    Newlines are located with one numpy pass PER 4 MB BLOCK (never
    rescanning carried bytes, so multi-block long-read records stay
    linear); strict 4-line records only (wrapped sequence/quality is
    refused, never silently misparsed), with blank lines tolerated where
    a HEADER is expected (between records; matches io/fastq.FastqReader).
    A blank line in the sequence position is a legitimate empty read."""
    f, own = open_maybe_gzip(path)
    try:
        parts: list = []       # unconsumed byte chunks, in order
        nls: list = []         # their newline positions (absolute)
        base = 0               # total unconsumed bytes
        n_nl = 0
        eof = False
        while True:
            if not eof:
                block = f.read(1 << 22)
                if block:
                    arr = np.frombuffer(block, np.uint8)
                    nl_new = np.flatnonzero(arr == 10).astype(np.int64)
                    nl_new += base
                    parts.append(block)
                    nls.append(nl_new)
                    base += len(block)
                    n_nl += nl_new.size
                else:
                    eof = True
                    if base and not parts[-1].endswith(b"\n"):
                        parts.append(b"\n")  # unterminated final line
                        nls.append(np.array([base], np.int64))
                        base += 1
                        n_nl += 1
            if base == 0:
                return
            if n_nl < 4 and not eof:
                continue  # no complete record can exist yet
            data = b"".join(parts)
            nl = (
                np.concatenate(nls) if len(nls) > 1
                else (nls[0] if nls else np.empty(0, np.int64))
            )

            def line_start(i: int) -> int:
                return 0 if i == 0 else int(nl[i - 1]) + 1

            li = 0
            consumed = 0
            # fast path: when every 4-line group in this flush is a
            # clean strict record (vectorized '@'/'+' check), group
            # without the per-line walk; any blank/odd line falls to
            # the walking loop below, which tolerates blanks at header
            # positions and raises on true multi-line FASTQ
            nrec = nl.size // 4
            if nrec:
                arr = np.frombuffer(data, np.uint8)
                starts = np.empty(4 * nrec, np.int64)
                starts[0] = 0
                starts[1:] = nl[: 4 * nrec - 1] + 1
                if (
                    (arr[starts[0::4]] == 0x40).all()
                    and (arr[starts[2::4]] == 0x2B).all()
                ):
                    seq_s = starts[1::4]
                    seq_e = nl[1::4][:nrec]
                    rec_s = starts[0::4]
                    rec_e = nl[3::4][:nrec] + 1
                    for i in range(nrec):
                        s1, e1 = int(seq_s[i]), int(seq_e[i])
                        if e1 > s1 and data[e1 - 1] == 0x0D:  # CRLF
                            e1 -= 1
                        yield (
                            data[s1:e1],
                            data[int(rec_s[i]) : int(rec_e[i])],
                        )
                    li = 4 * nrec
                    consumed = int(rec_e[-1])
            while True:
                # skip blank lines where a header is expected
                while li < nl.size:
                    s0 = line_start(li)
                    e0 = int(nl[li])
                    if e0 - s0 == 0 or (
                        e0 - s0 == 1 and data[s0] == 0x0D
                    ):
                        li += 1
                        consumed = e0 + 1
                        continue
                    break
                if li + 4 > nl.size:
                    break  # incomplete record: carry the tail
                s0 = line_start(li)
                s2 = line_start(li + 2)
                if data[s0] != 0x40 or data[s2] != 0x2B:
                    raise ValueError(
                        f"{path}: multi-line FASTQ is not supported "
                        "(expected @header/seq/+/quality groups)"
                    )
                s1 = line_start(li + 1)
                e1 = int(nl[li + 1])
                if e1 > s1 and data[e1 - 1] == 0x0D:  # CRLF
                    e1 -= 1
                e3 = int(nl[li + 3]) + 1
                yield data[s1:e1], data[s0:e3]
                li += 4
                consumed = e3
            if eof:
                # strip ONLY newline characters: a space-only trailing
                # line is malformed to the strict line reader
                # (FastqReader), and the flows must agree on
                # accept/reject
                if data[consumed:].strip(b"\r\n"):
                    raise ValueError(f"{path}: truncated FASTQ record")
                return
            rem = data[consumed:]
            parts = [rem] if rem else []
            nls = [nl[li:] - consumed] if li < nl.size else []
            base = len(rem)
            n_nl = nl.size - li
    finally:
        if own:
            f.close()


def _records_with_raw(path, fmt: str) -> Iterator[Tuple[bytes, bytes]]:
    """Yield (sequence_bytes, verbatim_record_bytes) per read.

    FASTQ: strict 4-line groups, quality preserved verbatim; FASTA:
    records re-emitted as '>header\\nseq\\n' (one line).  SAM/BAM is
    refused as the reference refuses it, with SystemExit (exit 1): its
    records cannot be re-emitted verbatim."""
    if fmt == "auto":
        fmt = sniff_format(path)
    if fmt in ("sam", "bam"):
        raise SystemExit(
            "findkmer filter reads FASTA/FASTQ only (SAM/BAM records "
            "cannot be re-emitted verbatim); convert first"
        )
    if fmt == "fastq":
        yield from _fastq_records_block(path)
        return
    with FastaReader(path) as reader:
        for header, seq in reader.records():
            raw = b">" + header.encode("ascii", "replace") + b"\n" + seq \
                + b"\n"
            yield seq, raw


def _resolve_engine(engine: str, device="cuda") -> str:
    """auto -> the device engine when `device` is CUDA, else the host
    engine.  On an H100 the device engine beat the C host scan (1 M reads
    of 150 bases against a k=21 canonical spectrum of 5.8 M codes:
    4.2-5.9 s against 7.3 s, `chip_smoke.py --only filter`); the
    reference picks its host scan, which beat its TPU engine.  Nothing
    falls back: a CUDA device that is not there raises where the device
    is resolved, for `auto` as for an explicit `device`."""
    if engine != "auto":
        return engine
    return "device" if torch.device(device).type == "cuda" else "host"


def _pipeline_depth() -> int:
    """In-flight device flushes (cross-flush pipelining depth).

    0 = synchronous (finish each flush before reading on)."""
    try:
        return max(0, int(os.environ.get("FINDKMER_FILTER_DEPTH", "2")))
    except ValueError:
        return 2


def _device_scorer(spec, device):
    from findkmer_torch import filter_device

    return filter_device.DeviceFilter(spec, device=device)


def _keep_mask(hits, wins, min_hits, min_frac, invert):
    """Vectorized pass/keep rule, float-identical to the scalar one
    (h/w >= frac via the same IEEE double division)."""
    ok = hits >= min_hits
    if min_frac is not None:
        nz = wins > 0
        frac_ok = np.zeros(ok.shape, bool)
        frac_ok[nz] = (hits[nz] / wins[nz]) >= min_frac
        ok &= frac_ok
    return ok != invert


def _emit_records(out_f, data, rec_s, rec_e, keep) -> int:
    """Write kept records as COALESCED spans of the block buffer:
    adjacent kept records merge into one write."""
    idx = np.flatnonzero(keep)
    if idx.size == 0:
        return 0
    mv = memoryview(data)
    brk = np.flatnonzero(rec_s[idx[1:]] != rec_e[idx[:-1]])
    run_a = np.concatenate(([0], brk + 1))
    run_b = np.concatenate((brk, [idx.size - 1]))
    for a, b in zip(run_a, run_b):
        out_f.write(mv[int(rec_s[idx[a]]) : int(rec_e[idx[b]])])
    return int(idx.size)


def _scored_segments(path, spec, engine, scorer=None, device="cuda"):
    """Offsets-flow scoring stream: yields (hits, wins, data, rec_s,
    rec_e) per SEGMENT (one scanned block), in input order.  Reads are
    scored in place in the block buffer (host: C scan at block offsets;
    device: C gather-encode into the packed wire), with the device
    engine keeping FINDKMER_FILTER_DEPTH flushes in flight (0: each
    flush is finished before reading on; it still runs on the device).
    Shared by the single-end and paired offsets flows; `scorer` lets
    paired callers share one DeviceFilter (one member table on the
    device) across both mate streams."""
    k = spec.k
    if engine == "device":
        if scorer is None:
            scorer = _device_scorer(spec, device)
        batch_bytes = scorer.need
        depth = _pipeline_depth()
    else:
        scorer = None
        batch_bytes = 8 << 20
        depth = 0
    segs: list = []        # (data, seq_s, joined_s, lens, rec_s, rec_e)
    nbases = nreads = 0
    pending: deque = deque()
    # test hook: small blocks force multi-segment flushes
    block_bytes = int(os.environ.get("FINDKMER_FILTER_BLOCK", str(1 << 22)))

    def score_host(segs_):
        for data, ss, js, lens, rs, re_ in segs_:
            h, w = native.filter_hits(
                data, ss, lens, k, spec.canonical, spec.codes,
                *spec.prefilter(),
            )
            yield (h, w, data, rs, re_)

    def drain_one():
        p, segs_ = pending.popleft()
        hits, wins = scorer.finish(p)
        off = 0
        for data, ss, js, lens, rs, re_ in segs_:
            n = ss.size
            yield (hits[off : off + n], wins[off : off + n],
                   data, rs, re_)
            off += n

    def flush():
        nonlocal segs, nbases, nreads
        if not segs:
            return
        if scorer is None:
            yield from score_host(segs)
        else:
            pending.append((scorer.begin_offsets(segs, nbases, nreads),
                            segs))
            while len(pending) > depth:
                yield from drain_one()
        segs = []
        nbases = nreads = 0

    for data, seq_s, seq_e, rec_s, rec_e in _fastq_blocks(
        path, block_bytes=block_bytes
    ):
        lens = seq_e - seq_s
        n = int(seq_s.size)
        bases = int(lens.sum())
        if segs and nbases + nreads + bases + n > batch_bytes:
            yield from flush()
        # joined-stream starts of this block's reads (one separator
        # slot between consecutive reads, across segment joints too):
        # current joined length is nbases + nreads - 1, so the next
        # read starts at nbases + nreads (also right when empty)
        js = np.empty(n, np.int64)
        js[0] = nbases + nreads
        np.cumsum(lens[:-1] + 1, out=js[1:])
        if n > 1:
            js[1:] += js[0]
        segs.append((data, seq_s, js, lens, rec_s, rec_e))
        nbases += bases
        nreads += n
    yield from flush()
    while pending:
        yield from drain_one()


def _filter_fastq_offsets(
    path, out_f, spec, *, min_hits, min_frac, invert, engine, device
) -> Tuple[int, int]:
    """Single-end FASTQ filtering on the offsets-based zero-copy flow:
    the C record scanner (_fastq_blocks) produces per-block offset
    arrays, reads are scored IN PLACE in the block buffer
    (_scored_segments), and kept records are emitted as coalesced block
    spans.  No per-read Python objects anywhere."""
    kept = seen = 0
    for h, w, data, rs, re_ in _scored_segments(path, spec, engine,
                                                device=device):
        seen += int(h.size)
        keep = _keep_mask(h, w, min_hits, min_frac, invert)
        kept += _emit_records(out_f, data, rs, re_, keep)
    return kept, seen


def _filter_fastq_offsets_paired(
    path1, path2, out1_f, out2_f, spec, *,
    min_hits, min_frac, invert, engine, pair_mode, device,
) -> Tuple[int, int]:
    """Paired-end offsets flow: each mate file runs its own
    _scored_segments stream (sharing ONE device scorer); the pair
    decision zips the two scored streams in aligned chunks and emits
    kept pairs as coalesced spans per side.  Same semantics as
    filter_file_paired's list flow (pairs kept/dropped together,
    outputs index-synchronized)."""
    scorer = _device_scorer(spec, device) if engine == "device" else None
    s1 = iter(_scored_segments(path1, spec, engine, scorer=scorer))
    s2 = iter(_scored_segments(path2, spec, engine, scorer=scorer))
    kept = seen = 0
    b1 = b2 = None  # (h, w, data, rs, re_), consumed offset
    o1 = o2 = 0

    def passes(h, w):
        # per-mate pass rule = _keep_mask before the pair-level invert
        return _keep_mask(h, w, min_hits, min_frac, False)

    while True:
        if b1 is None or o1 >= b1[0].size:
            b1, o1 = next(s1, None), 0
        if b2 is None or o2 >= b2[0].size:
            b2, o2 = next(s2, None), 0
        if b1 is None or b2 is None:
            if (b1 is None) != (b2 is None):
                raise ValueError(
                    f"paired inputs differ in read count ({path1} vs "
                    f"{path2}); pair {seen + 1} is unmatched"
                )
            break
        take = min(b1[0].size - o1, b2[0].size - o2)
        p1 = passes(b1[0][o1 : o1 + take], b1[1][o1 : o1 + take])
        p2 = passes(b2[0][o2 : o2 + take], b2[1][o2 : o2 + take])
        ok = (p1 | p2) if pair_mode == "any" else (p1 & p2)
        keep = ok != invert
        kept += _emit_records(
            out1_f, b1[2], b1[3][o1 : o1 + take], b1[4][o1 : o1 + take],
            keep,
        )
        _emit_records(
            out2_f, b2[2], b2[3][o2 : o2 + take], b2[4][o2 : o2 + take],
            keep,
        )
        seen += take
        o1 += take
        o2 += take
    return kept, seen


def _fast_flow(fmt: str) -> bool:
    """FASTQ inputs take the offsets flow when the C library is built;
    FINDKMER_FILTER_FAST=0 forces the list flow (same bytes)."""
    return (fmt == "fastq" and native.available()
            and os.environ.get("FINDKMER_FILTER_FAST", "1") == "1")


def _list_scorer(spec, engine, device):
    """(scorer, batch_bytes, depth) of the list flow."""
    if engine == "device":
        scorer = _device_scorer(spec, device)
        # one device batch per flush: the joined stream (bases +
        # separators) stays <= scorer.need
        return scorer, scorer.need, _pipeline_depth()
    if engine == "host":
        return spec, 8 << 20, 0
    raise ValueError(f"unknown filter engine {engine!r}")


def filter_file(
    path,
    out_f,
    spec: FilterSpec,
    *,
    fmt: str = "auto",
    min_hits: int = 1,
    min_frac: Optional[float] = None,
    invert: bool = False,
    engine: str = "auto",
    device="cuda",
) -> Tuple[int, int]:
    """Stream reads from `path`, write passing records to out_f.

    A read passes when hits >= min_hits AND (min_frac is None or
    hits/valid_windows >= min_frac); --invert keeps the complement.
    engine: "host" (OpenMP C scan / numpy), "device" (membership on the
    torch `device`, filter_device.py), or "auto" (_resolve_engine).
    Both engines are bit-for-bit interchangeable.
    Returns (reads kept, reads seen).

    FASTQ inputs take the offsets-based zero-copy flow when the native
    library is built (_filter_fastq_offsets: C record scan, in-place
    scoring, coalesced emit; FINDKMER_FILTER_FAST=0 forces the
    list-based flow; both are byte-identical)."""
    engine = _resolve_engine(engine, device)
    if fmt == "auto":
        fmt = sniff_format(path)
    if _fast_flow(fmt):
        return _filter_fastq_offsets(
            path, out_f, spec, min_hits=min_hits, min_frac=min_frac,
            invert=invert, engine=engine, device=device,
        )
    scorer, batch_bytes, depth = _list_scorer(spec, engine, device)
    kept = seen = 0
    batch_seqs: list = []
    batch_raws: list = []
    nbytes = 0
    pending: deque = deque()  # device engine: begin()s awaiting finish

    def emit(hits, windows, raws):
        nonlocal kept
        for raw, h, w in zip(raws, hits, windows):
            ok = h >= min_hits
            if ok and min_frac is not None:
                ok = w > 0 and h / w >= min_frac
            if bool(ok) != invert:
                out_f.write(raw)
                kept += 1

    def drain_one():
        p, raws = pending.popleft()
        emit(*scorer.finish(p), raws)

    def flush():
        nonlocal batch_seqs, batch_raws, nbytes
        if not batch_seqs:
            return
        if depth:
            # dispatch this flush's device work and KEEP READING: its
            # D2H and attribution overlap the next flush's device work
            pending.append((scorer.begin(batch_seqs), batch_raws))
            batch_seqs, batch_raws = [], []  # moved into pending
            while len(pending) > depth:
                drain_one()
        else:
            emit(*scorer.hits_batch(batch_seqs), batch_raws)
            batch_seqs.clear()
            batch_raws.clear()
        nbytes = 0

    for seq, raw in _records_with_raw(path, fmt):
        seen += 1
        # flush BEFORE appending once this read would overflow the
        # batch (joined size = bases + one 'N' separator per joint), so
        # a flush's joined stream never exceeds batch_bytes
        if batch_seqs and nbytes + len(batch_seqs) + len(seq) > batch_bytes:
            flush()
        batch_seqs.append(seq)
        batch_raws.append(raw)
        nbytes += len(seq)
        if len(batch_seqs) >= 65536:
            flush()
    flush()
    while pending:
        drain_one()
    return kept, seen


def filter_file_paired(
    path1,
    path2,
    out1_f,
    out2_f,
    spec: FilterSpec,
    *,
    fmt: str = "auto",
    min_hits: int = 1,
    min_frac: Optional[float] = None,
    invert: bool = False,
    engine: str = "auto",
    pair_mode: str = "any",
    device="cuda",
) -> Tuple[int, int]:
    """Paired-end filtering: R1/R2 streamed in lockstep, PAIRS kept or
    dropped together (a kept pair writes mate 1 to out1_f and mate 2 to
    out2_f, so the outputs stay index-synchronized: the BBDuk/seqkit
    paired contract).

    pair_mode: "any" keeps the pair when EITHER mate passes the
    min_hits/min_frac rule (the usual keep-if-matches semantics);
    "both" requires both mates to pass.  --invert keeps the complement
    of the pair-level decision.  Returns (pairs kept, pairs seen);
    raises on files with different read counts."""
    if pair_mode not in ("any", "both"):
        raise ValueError(f"unknown pair mode {pair_mode!r}")
    engine = _resolve_engine(engine, device)
    if fmt == "auto":
        fmt1, fmt2 = sniff_format(path1), sniff_format(path2)
        fmt = fmt1 if fmt1 == fmt2 else "auto"
    if _fast_flow(fmt):
        return _filter_fastq_offsets_paired(
            path1, path2, out1_f, out2_f, spec, min_hits=min_hits,
            min_frac=min_frac, invert=invert, engine=engine,
            pair_mode=pair_mode, device=device,
        )
    scorer, batch_bytes, depth = _list_scorer(spec, engine, device)
    kept = seen = 0
    b_seqs: list = []   # interleaved mate1, mate2, mate1, ...
    b_raws: list = []
    nbytes = 0
    pending: deque = deque()

    def passes(h, w):
        ok = h >= min_hits
        if ok and min_frac is not None:
            ok = w > 0 and h / w >= min_frac
        return bool(ok)

    def emit(hits, windows, raws):
        nonlocal kept
        for i in range(0, len(raws), 2):
            p1 = passes(hits[i], windows[i])
            p2 = passes(hits[i + 1], windows[i + 1])
            ok = (p1 or p2) if pair_mode == "any" else (p1 and p2)
            if ok != invert:
                out1_f.write(raws[i])
                out2_f.write(raws[i + 1])
                kept += 1

    def drain_one():
        p, raws = pending.popleft()
        emit(*scorer.finish(p), raws)

    def flush():
        nonlocal b_seqs, b_raws, nbytes
        if not b_seqs:
            return
        if depth:
            pending.append((scorer.begin(b_seqs), b_raws))
            b_seqs, b_raws = [], []
            while len(pending) > depth:
                drain_one()
        else:
            emit(*scorer.hits_batch(b_seqs), b_raws)
            b_seqs.clear()
            b_raws.clear()
        nbytes = 0

    it1 = _records_with_raw(path1, fmt)
    it2 = _records_with_raw(path2, fmt)
    while True:
        r1 = next(it1, None)
        r2 = next(it2, None)
        if r1 is None and r2 is None:
            break
        if r1 is None or r2 is None:
            raise ValueError(
                f"paired inputs differ in read count ({path1} vs "
                f"{path2}); pair {seen + 1} is unmatched"
            )
        seen += 1
        pair_bases = len(r1[0]) + len(r2[0])
        # flush before the pair that would overflow one device batch
        # (joined size = bases + separators); pairs are never split
        if b_seqs and nbytes + len(b_seqs) + 1 + pair_bases > batch_bytes:
            flush()
        for seq, raw in (r1, r2):
            b_seqs.append(seq)
            b_raws.append(raw)
            nbytes += len(seq)
        if len(b_seqs) >= 65536:
            flush()
    flush()
    while pending:
        drain_one()
    return kept, seen
