"""Host input of the port: readers, the byte encoder, the C library's
loader.  The port's own copies of `findkmer_tpu/io/*`; the exports are
the reference's, and `FastqReader` (the reference keeps it in
`io/fastq.py` without exporting it)."""

from findkmer_torch.io.encode import (
    INVALID,
    encode_bytes,
    encoder_backend,
    pack_2bit,
    unpack_2bit,
)
from findkmer_torch.io.fasta import FastaReader, RecordChunk, read_records
from findkmer_torch.io.fastq import FastqReader
from findkmer_torch.io.sam import BamReader, SamReader

__all__ = [
    "FastaReader",
    "FastqReader",
    "BamReader",
    "SamReader",
    "RecordChunk",
    "read_records",
    "encode_bytes",
    "INVALID",
    "encoder_backend",
    "pack_2bit",
    "unpack_2bit",
]
