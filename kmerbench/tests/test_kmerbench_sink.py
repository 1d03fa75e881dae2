"""The sink drains named pipes in order, keeps each stream's length and
block CRCs, and ends a job that never wrote its pipes."""

import os
from concurrent.futures import ThreadPoolExecutor

from kmerbench import blocks
from kmerbench.sink import Sink, make_pipe


def test_streams_in_order_with_their_digests(tmp_path, monkeypatch):
    monkeypatch.setattr(blocks, "BLOCK", 1 << 16)
    import kmerbench.sink as sink_mod
    monkeypatch.setattr(sink_mod, "BLOCK", 1 << 16)
    paths = [make_pipe(str(tmp_path / f"{i}.tsv")) for i in range(3)]
    datas = [os.urandom(n) for n in (0, 1 << 16, 5 * (1 << 16) + 123)]
    sink = Sink(2)
    try:
        sink.expect(paths)
        for p, d in zip(paths, datas):
            with open(p, "wb") as f:
                for s in range(0, len(d), 7777):
                    f.write(d[s : s + 7777])
        got = sink.wait(3)
    finally:
        sink.close()
    with ThreadPoolExecutor(2) as pool:
        for g, p, d in zip(got, paths, datas):
            want = blocks.digest_pieces([d], pool)
            assert g.path == p
            assert g.digest.nbytes == len(d)
            assert blocks.blocks_differing(g.digest, want) == 0
    assert got[0].t_close <= got[1].t_close <= got[2].t_close


def test_a_failed_job_is_ended(tmp_path):
    paths = [make_pipe(str(tmp_path / f"{i}.tsv")) for i in range(2)]
    sink = Sink(1)
    try:
        sink.expect(paths)
        got = sink.abort(2)
    finally:
        sink.close()
    assert [g.digest.nbytes for g in got] == [0, 0]


def test_blocks_differing_counts_changed_missing_and_extra():
    with ThreadPoolExecutor(2) as pool:
        data = os.urandom(3 * blocks.BLOCK + 10)
        want = blocks.digest_pieces([data], pool)
        flip = bytearray(data)
        flip[blocks.BLOCK + 5] ^= 1
        assert blocks.blocks_differing(
            blocks.digest_pieces([bytes(flip)], pool), want) == 1
        short = blocks.digest_pieces([data[: blocks.BLOCK]], pool)
        assert blocks.blocks_differing(short, want) == 3
        assert blocks.blocks_differing(want, short) == 3
        pieces = [data[i : i + 1000003] for i in range(0, len(data), 1000003)]
        assert blocks.digest_pieces(pieces, pool).crcs == want.crcs
