"""Host input of the port: readers, the byte encoder, the C library's
loader.  The port's own copies of `findkmer_tpu/io/*`."""

from findkmer_torch.io.encode import INVALID, encode_bytes
from findkmer_torch.io.fasta import FastaReader, RecordChunk
from findkmer_torch.io.fastq import FastqReader
from findkmer_torch.io.sam import BamReader, SamReader

__all__ = [
    "FastaReader",
    "FastqReader",
    "BamReader",
    "SamReader",
    "RecordChunk",
    "encode_bytes",
    "INVALID",
]
