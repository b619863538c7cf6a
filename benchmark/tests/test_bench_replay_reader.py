"""``lift_graph_replay_pct``'s reader on recorded spans made up here: a
program whose ``lift.forward`` spans carry no ``graph`` argument reads
nothing, and a mix of replays and eager calls reads the replayed rows'
share."""

import pytest

from benchmark import spans, spec

READ = spec.reader("lift_graph_replay_pct")
SERVE = {"kind": "serve"}


def _forward(rows, graph=None, **args):
    args = dict(args, rows=rows)
    if graph is not None:
        args["graph"] = graph
    return {"name": "lift.forward", "id": 1, "parent": None, "thread": 1,
            "start_ns": 0, "end_ns": 1000, "args": args}


def _window(monkeypatch, items):
    monkeypatch.setattr(spans, "recorded", lambda: {
        "spans": items, "device": [], "samples": []})


def test_the_metric_is_declared_for_the_serving_cell():
    cell = spec.load_cell("serve.motionbert_lite.poisson")
    (m,) = [m for m in cell.per_layer if m["name"] == "lift_graph_replay_pct"]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
        "%", "higher", "program_counter", "api and eval step", "lift_p50_ms")
    assert "lift_graph_replay_pct" not in [
        m["name"] for m in spec.load_cell("train.motionbert.b32").per_layer]


def test_spans_without_the_argument_read_nothing(monkeypatch):
    _window(monkeypatch, [_forward(8), _forward(1), _forward(32)])
    assert READ(SERVE) is None
    _window(monkeypatch, [])
    assert READ(SERVE) is None


def test_a_mix_reads_the_replayed_rows_share(monkeypatch):
    other = dict(_forward(4, 1), name="serve.model")
    _window(monkeypatch, [_forward(8, 1), _forward(1, 0), _forward(32, 1),
                          _forward(128, 0), other])
    assert READ(SERVE) == pytest.approx(100.0 * 40 / 169)
    assert READ({"kind": "train"}) is None
    assert READ({}) is None


@pytest.mark.parametrize("graph,want", [(1, 100.0), (0, 0.0)])
def test_all_replayed_or_all_eager(monkeypatch, graph, want):
    _window(monkeypatch, [_forward(r, graph) for r in (1, 8, 32, 128)])
    assert READ(SERVE) == want
