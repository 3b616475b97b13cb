"""The port's one launch tally (``repro_torch.kernels.launches``) on the
CPU: a capture defers the keys of its launches to each replay of its
graph (the capture state and the graph stood in for on the host), the
tally's sums and its ``uncounted`` scope over the keys of all six
kernels, and no question about the capture state outside a capture."""

import collections
import contextlib

import pytest
import torch

from repro_torch.kernels import launches, ops

# one key of each kernel the tally counts
KEYS = [("regs", 8, 751_894_528, 1), ("warp", 32, 10, 32),
        ("smem", 66, 1_048_576, 1), ("two_pass", 128, 15_730_944, 1),
        ("finite_scan", 1, 15_730_944, 1), ("residual", 9, 751_894_528, 1)]


@pytest.fixture
def fake_capture(monkeypatch):
    """A CUDA graph and the stream's capture state, on the host: the
    state is True inside ``torch.cuda.graph``; ``asked`` counts the
    questions about it."""
    state = {"capturing": False, "asked": 0}

    def capturing():
        state["asked"] += 1
        return state["capturing"]

    @contextlib.contextmanager
    def graph(_graph):
        state["capturing"] = True
        try:
            yield
        finally:
            state["capturing"] = False

    class Graph:
        def replay(self):
            pass

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        capturing)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    return state


def test_a_capture_defers_its_keys_to_each_replay(fake_capture):
    with launches.uncounted():
        before = launches.COUNTS.copy()

        def step():
            launches.note(KEYS[0])        # what the wrappers do on the card
            launches.note(KEYS[4])
            launches.note(KEYS[0])
            return torch.zeros(3)

        graph, out, keys = ops.capture_graph(step)
        assert keys == collections.Counter({KEYS[0]: 2, KEYS[4]: 1})
        assert launches.COUNTS == before  # the capture ran nothing
        program = ops.LaunchProgram(step, torch.zeros(2, 3), torch.ones(2),
                                    None)
        program.graph, program.out, program.launches = graph, out, keys
        for _ in range(3):
            assert program.replay() is out
        assert program.replays == 3
        assert launches.COUNTS - before == collections.Counter(
            {KEYS[0]: 6, KEYS[4]: 3})
        launches.note(KEYS[0])            # after the capture: counted
        assert launches.COUNTS[KEYS[0]] == before[KEYS[0]] + 7
    assert launches._SCOPES == []


def test_total_and_uncounted_cover_all_six_kernels():
    saved = launches.COUNTS.copy()
    with launches.uncounted():
        launches.COUNTS.clear()
        for i, key in enumerate(KEYS):
            for _ in range(i + 1):
                launches.note(key)
        assert launches.total() == 21
        assert [launches.total(key[0]) for key in KEYS] == [1, 2, 3, 4, 5, 6]
        assert launches.total("regs", "warp", "smem", "two_pass") == 10
        assert launches.total("finite_scan", "residual") == 11
        assert launches.total("absent") == 0
        with launches.uncounted():
            launches.replay(KEYS)
            launches.replay({KEYS[3]: 5})
            assert launches.total() == 32
            assert launches.total("two_pass") == 10
        assert launches.total() == 21    # the inner scope's launches went
    assert launches.COUNTS == saved


def test_note_asks_about_capture_only_inside_a_scope(fake_capture):
    with launches.uncounted():
        launches.note(KEYS[4])            # a submit's finiteness check
        assert fake_capture["asked"] == 0
        with launches.captured() as keys:
            launches.note(KEYS[4])        # in a scope, not capturing
        assert fake_capture["asked"] == 1 and keys == []
        assert launches.total("finite_scan") >= 2
