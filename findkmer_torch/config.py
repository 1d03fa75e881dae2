"""Single Config dataclass for the whole engine.

The port's copy of `findkmer_tpu/config.py`: the same fields and the same
defaults, so the port resolves the same table mode and the same store and
batch geometry as the reference it is held against.  All knobs live in one
frozen dataclass that the CLI constructs and the pipeline
threads through explicitly: no global flag registry, no ambient state.
A Config carries over field for field, and `to_json` writes the same
string as the reference's (the checkpoint manifest stores it, and either
package loads the other's).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass


# Table modes
DIRECT = "direct"   # dense 4^k table, direct-addressed (k <= direct_k_max)
SPARSE = "sparse"   # sorted sparse (code, count) store (any k, required k > 16)
AUTO = "auto"       # pick per k

# Dense-count accumulation algorithms (ops/histogram.py)
HIST_SCATTER = "scatter"     # scatter-add (index_add_)
HIST_SORT = "sort"           # sort + run-length + sparse scatter
HIST_ONEHOT = "onehot"       # one-hot matmul (small k only)
HIST_PALLAS = "pallas"       # the fused window+histogram kernel
HIST_AUTO = "auto"

# Distributed merge strategies (parallel/dist.py)
MERGE_PSUM = "psum"                  # replicated table, all-reduce
MERGE_PSUM_SCATTER = "psum_scatter"  # reduce-scatter into table shards
MERGE_ALL_TO_ALL = "all_to_all"      # route codes to owner shard, local add
MERGE_AUTO = "auto"


@dataclass(frozen=True)
class Config:
    """All engine knobs.  Frozen: derive variants with `replace()`."""

    k: int = 8
    canonical: bool = False          # count min(kmer, revcomp)

    # --- table ---
    table_mode: str = AUTO           # direct | sparse | auto
    direct_k_max: int = 10           # largest k for a dense 4^k table in
    # auto mode: the histogram kernels cover k <= 10; above that auto
    # routes to the sparse sort path.  `count` of one combined spectrum
    # takes the dense table above it too where both 4^k and the input's
    # bytes pass the sparse store's ceiling (`cli.SPARSE_CEILING`,
    # 2^28 = 4^14): at k = 15, a 4 GiB table of int32 counts.
    count_dtype: str = "int32"       # count dtype; exact (int32 overflows
                                     # only past 2^31 observations)
    sparse_capacity: int = 1 << 22   # max DISTINCT k-mers in the sparse
                                     # store (overflow-checked at compaction)
    sparse_compact_entries: int = 1 << 28
    # Compaction trigger: buffered raw window codes are sorted + RLE'd
    # into the store once this many accumulate.  Ingest between
    # compactions is append-only (merging sorted runs = re-sorting the
    # concatenation, so any earlier sorting is wasted work).  268M entries
    # are 2.1 GB of raw codes plus a like-sized sort workspace, and large
    # enough that a 248 Mbase chromosome finishes in a single raw-only
    # compaction, never touching the slower store-carrying path.
    spill_dir: str = ""
    # Disk-spill directory ("" = off, sparse mode only): crossing
    # sparse_capacity distinct k-mers spills the compacted store to a
    # sorted run file instead of raising (spill.py).
    sparse_expected_entries: int = 0
    # Optional hint: expected total windows (~input bases).  When set
    # (the CLI sets it from input file sizes) the raw buffer is
    # pre-sized once instead of growing through the ladder.  0 = unknown,
    # grow by doubling.

    # --- batching / streaming (pipeline.py) ---
    batch_rows: int = 1024           # B: rows per device batch
    chunk_len: int = 65536           # L: owned bases per row (halo adds k-1)
    # 1024 x 65536 = 67 Mbase/batch: big batches amortize per-dispatch
    # latency; small inputs just pad (or shrink) the final batch
    prefetch: int = 2                # host->device double-buffer depth

    # --- histogram algorithm ---
    hist: str = HIST_AUTO

    # --- distribution (parallel/) ---
    devices: int = 1                 # devices in the 1-D mesh: 1 = the
                                     # single-device engine
    merge: str = MERGE_AUTO
    route_capacity_factor: float = 2.5  # all-to-all per-bucket slack
    # over the uniform 1/n_dev share

    # --- output (output.py) ---
    zeros: bool = False              # emit zero-count k-mers (small k only)
    sep: str = "\t"
    out_counts_only: bool = False    # emit COUNT without the KMER column
    min_count: int = 0               # suppress k-mers with count < min_count
    max_count: int = 0               # ... and count > max_count (0 = off);
    # the KMC/Jellyfish -ci/-cx output thresholds: an OUTPUT filter only,
    # counting stays exact

    # --- input ---
    input_format: str = "auto"       # auto | fasta | fastq | sam | bam (gzip is
                                     # detected by magic bytes either way)
    min_qual: int = 0                # mask bases with phred < min_qual to N
                                     # (FASTQ/SAM/BAM; 0 = off)
    qual_offset: int = 33            # ASCII phred offset for FASTQ/SAM text
                                     # qualities (BAM is raw phred)

    # --- runtime ---
    use_native_encode: bool = True   # prefer the C encoder when built
    packed_h2d: bool = True
    # ship batches as 2-bit-packed codes + validity bitmask (0.375 B/base
    # vs 1 B/base) and unpack on device: a quarter of the transfer volume
    seed: int = 0

    def __post_init__(self):
        if self.k <= 0:
            raise ValueError(f"k must be positive, got {self.k}")
        if self.k > 31:
            raise ValueError(f"k > 31 unsupported (code > 62 bits), got {self.k}")
        if self.table_mode not in (DIRECT, SPARSE, AUTO):
            raise ValueError(f"bad table_mode {self.table_mode!r}")
        if self.chunk_len < self.k:
            raise ValueError(
                f"chunk_len ({self.chunk_len}) must be >= k ({self.k})"
            )
        if self.input_format not in ("auto", "fasta", "fastq", "sam", "bam"):
            raise ValueError(f"bad input_format {self.input_format!r}")
        if self.count_dtype not in ("int32", "int64"):
            raise ValueError(
                f"count_dtype must be int32 or int64, got "
                f"{self.count_dtype!r}"
            )
        if not 0 <= self.min_qual <= 94:
            raise ValueError(
                f"min_qual must be in 0..94 (phred), got {self.min_qual}"
            )
        if self.min_qual and self.input_format == "fasta":
            raise ValueError(
                "min_qual requires a quality-bearing input format "
                "(fastq/sam/bam); FASTA has no qualities"
            )

    # ------------------------------------------------------------------
    @property
    def resolved_table_mode(self) -> str:
        if self.table_mode != AUTO:
            # int32 window codes address at most 4^15; k=16 would also
            # allocate a 17 GB table: reject at config time
            if self.table_mode == DIRECT and self.k > 15:
                raise ValueError(f"direct table requires k <= 15, got k={self.k}")
            return self.table_mode
        return DIRECT if self.k <= self.direct_k_max else SPARSE

    @property
    def table_size(self) -> int:
        """Dense table entry count (only meaningful in direct mode)."""
        return 4 ** self.k

    @property
    def window_len(self) -> int:
        """Windows owned per row: chunk_len (thanks to the k-1 halo)."""
        return self.chunk_len

    @property
    def row_len(self) -> int:
        """Device row length: k-1 halo bases + chunk_len owned bases."""
        return self.chunk_len + self.k - 1

    @property
    def needs_wide_codes(self) -> bool:
        """True when a window code exceeds 31 bits (k > 15): int64 codes
        in the port, (hi, lo) pairs in a checkpoint's planes."""
        return self.k > 15

    # ------------------------------------------------------------------
    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls(**json.loads(s))
