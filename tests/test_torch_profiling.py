"""The port's observability on tests/test_profiling.py's cases: the stage
recorder (its stages also regions of the trace), ``device_trace`` writing a torch.profiler Chrome trace (here of
CPU ops), ``annotate`` naming a region in it, and ZEROCHAIN_TRACE."""

import json
import time

import torch

from zerochain_tpu_torch.utils.profiling import (
    StageRecorder, annotate, device_trace, trace_dir_from_env,
)


def test_stage_recorder_contexts_and_marks(tmp_path):
    """Stages accumulate in insertion order, call ``sync`` at their end, and
    mark their regions in a torch.profiler trace."""
    synced = []
    rec = StageRecorder(sync=lambda: synced.append(1))
    with device_trace(str(tmp_path / "trace")):
        with rec.stage("a"):
            time.sleep(0.01)
        with rec.stage("b"):
            torch.ones(4).sum()
        with rec.stage("a"):  # accumulates
            time.sleep(0.01)
    assert list(rec.timings) == ["a", "b"]
    assert rec.timings["a"] >= 0.02 and rec.timings["b"] >= 0.0
    assert len(synced) == 3
    (trace,) = (tmp_path / "trace").glob("trace_*.json")
    names = [e.get("name") for e in json.loads(trace.read_text())["traceEvents"]]
    assert names.count("a") == 2 and names.count("b") == 1


def test_device_trace_noop_and_real(tmp_path):
    with device_trace(None):  # disabled: must be free
        pass
    assert not any(tmp_path.rglob("*"))
    with device_trace(str(tmp_path / "trace")):
        with annotate("zc_region"):
            (torch.arange(8) * 2).sum()
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "zc_region" in names
    assert any(str(n).startswith("aten::") for n in names)
    with device_trace(str(tmp_path / "trace")):  # a second trace, own file
        torch.ones(4).sum()
    assert len(list((tmp_path / "trace").glob("trace_*.json"))) == 2


def test_trace_dir_env(monkeypatch):
    monkeypatch.delenv("ZEROCHAIN_TRACE", raising=False)
    assert trace_dir_from_env() is None
    monkeypatch.setenv("ZEROCHAIN_TRACE", "/tmp/x")
    assert trace_dir_from_env() == "/tmp/x"


def test_prove_traces_under_zerochain_trace(tmp_path, monkeypatch):
    """ConfidentialProver.prove wraps its work in device_trace of
    ZEROCHAIN_TRACE, as the JAX prover does (driven on a stand-in for the
    pipeline's body: no CRS is built)."""
    from types import SimpleNamespace

    from zerochain_tpu_torch.prover.pipeline import ConfidentialProver

    def body(assignments, rs):
        with annotate("zc_body"):
            torch.ones(4).sum()
        return ["proof"]

    stub = SimpleNamespace(_prove_impl=body)
    monkeypatch.delenv("ZEROCHAIN_TRACE", raising=False)
    assert ConfidentialProver.prove(stub, []) == ["proof"]
    assert not any(tmp_path.rglob("*"))
    monkeypatch.setenv("ZEROCHAIN_TRACE", str(tmp_path / "t"))
    assert ConfidentialProver.prove(stub, []) == ["proof"]
    (trace,) = (tmp_path / "t").glob("trace_*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert "zc_body" in names
