"""A run with the timed path broken underneath comes out not correct, for
each fault a cell can have: a step that returns its state unchanged, half
of each batch left out, an answer altered where it is produced.  (No cell
runs across cards, so none can leave out an exchange between them.)  The
runs skip the look for a card and count on the CPU at the tiny size."""

import pytest

from kmerbench.spans import _patch

from test_kmerbench_run import CELLS, rehearse


def step_unchanged():
    from findkmer_torch.models.counter import KmerCounter

    return [_patch(KmerCounter, "step", lambda fn: lambda self, state,
                   batch: state)]


def half_batch():
    from findkmer_torch.models.counter import KmerCounter

    def half(b):
        if isinstance(b, (tuple, list)):
            return type(b)(x[: x.shape[0] // 2] for x in b)
        return b[: b.shape[0] // 2]

    return [_patch(KmerCounter, "step", lambda fn: lambda self, state, batch:
                   fn(self, state, half(batch)))]


def answer_altered():
    from findkmer_torch import api, output

    def chunk(fn):
        def wrapped(*a, **kw):
            out = bytearray(fn(*a, **kw))
            if out:
                out[-2] = ord("0") + (out[-2] - ord("0") + 1) % 10
            return bytes(out)
        return wrapped

    def histo(fn):
        def wrapped(self, *a, **kw):
            h = fn(self, *a, **kw)
            h[1] += 1
            return h
        return wrapped

    return [_patch(output, "_format_chunk", chunk),
            _patch(api.Spectrum, "histo", histo)]


@pytest.mark.parametrize("fault", [step_unchanged, half_batch,
                                   answer_altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell_name", CELLS)
def test_a_broken_path_is_not_correct(cell_name, fault):
    _, r = rehearse(cell_name, traced=False, fault=fault)
    assert not r["correct"]
    assert r["compared"]["blocks_differing"]["value"] > 0
