"""The port's library API (`findkmer_torch.count` / `count_per_record` /
`count_text`, `Spectrum`) vs `findkmer_tpu.api`, and its `selftest`.

Both APIs count the same inputs in this process; every view of the
result must agree: `to_dict`, `items`, `[]`, `total`, `distinct`,
`histo` and the bytes `write` produces.  Counts are integers: equality is
exact.
"""

import io
import os

import pytest
import torch

import findkmer_tpu as fk
import findkmer_torch as fkt
from findkmer_torch import api
from findkmer_torch import cli as torch_cli
from findkmer_torch.ops import window as window_ops

torch.set_num_threads(1)  # six test workers share the cores
CPU = "cpu"
COUNTS = {
    "tiny_k4": ("tiny", 4, {}),
    "multi_k5": ("multi", 5, dict(chunk_len=128, batch_rows=2)),
    "ecoli_k8_canonical": ("ecoli_frag", 8,
                           dict(canonical=True, chunk_len=1024,
                                batch_rows=4)),
    "tiny_k17_sparse": ("tiny", 17, dict(sparse_capacity=4096, chunk_len=64,
                                         batch_rows=2)),
    "multi_k21_canonical": ("multi", 21, dict(canonical=True, chunk_len=128,
                                              batch_rows=2)),
}


def _same_spectrum(got, want):
    assert isinstance(got, api.Spectrum)
    d = want.to_dict()
    assert got.to_dict() == d
    assert list(got.items()) == list(want.items())
    assert got.total() == want.total() and got.distinct() == want.distinct()
    assert (got.histo() == want.histo()).all()
    assert (got.histo(3) == want.histo(3)).all()
    for kmer in list(d)[:5] + ["A" * got.k, "T" * got.k]:
        assert got[kmer] == want[kmer], kmer
        assert got[window_ops.str_to_code(kmer)] == want[kmer]
    for kw in ({}, {"sep": ","}):
        a, b = io.BytesIO(), io.BytesIO()
        got.write(a, **kw)
        want.write(b, **kw)
        assert a.getvalue() == b.getvalue()
    if got._dense is not None:
        a, b = io.BytesIO(), io.BytesIO()
        got.write(a, zeros=True)
        want.write(b, zeros=True)
        assert a.getvalue() == b.getvalue()


@pytest.mark.parametrize("case", list(COUNTS))
def test_count_matches_jax_api(fixtures_dir, tmp_path, case):
    name, k, kw = COUNTS[case]
    path = os.path.join(fixtures_dir, f"{name}.fa")
    want = fk.count(path, k, **kw)
    got = fkt.count(path, k, device=CPU, **kw)
    _same_spectrum(got, want)
    want.write(str(tmp_path / "j.tsv"))
    got.write(str(tmp_path / "t.tsv"))
    assert (tmp_path / "t.tsv").read_bytes() == \
        (tmp_path / "j.tsv").read_bytes()


def test_count_several_inputs_and_torch_device(fixtures_dir):
    paths = [os.path.join(fixtures_dir, f"{n}.fa") for n in ("tiny", "multi")]
    want = fk.count(paths, 6, chunk_len=128, batch_rows=2)
    got = fkt.count(paths, 6, device=torch.device("cpu"), chunk_len=128,
                    batch_rows=2)
    _same_spectrum(got, want)


@pytest.mark.parametrize("fused", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("k", [4, 11])
def test_count_per_record_matches_jax_api(fixtures_dir, k, fused):
    path = os.path.join(fixtures_dir, "multi.fa")
    kw = dict(chunk_len=64, batch_rows=2, use_native_encode=fused)
    want = list(fk.count_per_record(path, k, **kw))
    got = list(fkt.count_per_record([path], k, device=CPU, **kw))
    assert [h for h, _ in got] == [h for h, _ in want]
    assert len(got) == 5
    for (_, g), (_, w) in zip(got, want):
        _same_spectrum(g, w)


@pytest.mark.parametrize("k, kw", [
    (3, {}), (4, dict(canonical=True)), (13, dict(chunk_len=64)),
])
def test_count_text_matches_jax_api(k, kw):
    text = ">r1 x\nACGTACGTnnACGTTTGCA\n>r2\n\n>r3\nggcaRACGTAC\nGTAA\n"
    _same_spectrum(fkt.count_text(text, k, device=CPU, **kw),
                   fk.count_text(text, k, **kw))


def test_api_device_is_explicit(fixtures_dir):
    path = os.path.join(fixtures_dir, "tiny.fa")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            fkt.count(path, 4)  # device defaults to cuda
    with pytest.raises(ValueError):
        fkt.count_text(">r\nACGT\n", 2, device="tpu")
    assert fkt.count is api.count and fkt.Spectrum is api.Spectrum
    with pytest.raises(AttributeError):
        fkt.no_such_name


def test_selftest_passes_on_cpu(capsys):
    assert torch_cli.main(["selftest", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "device: cpu" in out
    assert out.count("PASS") == 3
    assert "selftest OK (3/3 cases bit-exact)" in out


def test_selftest_fails_when_a_window_is_dropped(monkeypatch, capsys):
    """An extraction that loses the first valid window of each batch:
    the dense case (k=4, the plain extraction on the CPU) fails, with a
    FAIL line and exit code 1; the sparse cases (their own extraction)
    still pass."""
    orig = window_ops.window_codes

    def drop_one(rows, k, canonical=False):
        codes, valid = orig(rows, k, canonical)
        flat = valid.reshape(-1)
        first = int(torch.nonzero(flat)[0])
        flat[first] = False
        return codes, valid

    monkeypatch.setattr(window_ops, "window_codes", drop_one)
    assert torch_cli.main(["selftest", "--device", "cpu", "--seed", "3"]) == 1
    cap = capsys.readouterr()
    assert "FAIL k=4 [direct]" in cap.err
    assert "selftest FAILED (1/3 cases)" in cap.err
    assert cap.out.count("PASS") == 2


def test_selftest_refuses_other_device_counts(capsys):
    assert torch_cli.main(["selftest", "--device", "cpu",
                           "--devices", "2"]) == 2
    err = capsys.readouterr().err
    assert "not yet ported" in err and len(err.strip().splitlines()) == 1
