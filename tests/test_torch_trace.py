"""The port's trace export (``svs_tpu_torch.utils.trace.profiler_trace``):
with ``SVS_TPU_PROFILE_DIR`` set (read at call time), a retrieval on the
CPU writes a ``torch.profiler`` trace under ``<dir>/retrieve/`` (a pairwise
call under ``<dir>/pairwise/``), the reference's layout; unset, nothing
is written and the block is one ``record_function`` range.  The device is
synchronised before a profile starts and before it stops, and importing
the package asks Kineto to tear CUPTI down after each profile."""

import json
import threading

import pytest
import torch

from svs_tpu_torch import KB
from svs_tpu_torch.utils import trace

from kb_helpers import make_onehot_embedder

torch.set_num_threads(2)


@pytest.fixture
def kb(tmp_path):
    kb = KB(tmp_path / "kb.sqlite", make_onehot_embedder(), force_fresh_db=True, device="cpu")
    with kb.bulk_add_docs() as add:
        for i in range(12):
            add(f"vec:{i}")
    yield kb
    kb.close()


def _traces(root):
    return sorted(root.rglob("*.pt.trace.json"))


def test_retrieve_writes_a_trace_under_the_label(kb, tmp_path, monkeypatch):
    prof = tmp_path / "prof"
    monkeypatch.setenv("SVS_TPU_PROFILE_DIR", str(prof))
    hits = kb.retrieve("vec:3", 2)
    assert hits[0]["doc"]["text"] == "vec:3"
    files = _traces(prof)
    assert files and all(f.parent == prof / "retrieve" for f in files)
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "retrieve" for e in events)
    kb.document_top_pairwise_scores(3)
    assert _traces(prof / "pairwise")


def test_unset_writes_nothing(kb, tmp_path, monkeypatch):
    monkeypatch.delenv("SVS_TPU_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    kb.retrieve("vec:3", 2)
    assert _traces(tmp_path) == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        with trace.profiler_trace("marked"):
            torch.ones(2) + 1
    assert any(e.key == "marked" for e in p.key_averages())


def test_a_second_concurrent_block_is_only_marked(tmp_path, monkeypatch):
    """``torch.profiler`` sessions do not nest: while one block traces,
    another thread's block runs unprofiled (marked), and both finish."""
    monkeypatch.setenv("SVS_TPU_PROFILE_DIR", str(tmp_path))
    inside, release = threading.Event(), threading.Event()

    def first():
        with trace.profiler_trace("first"):
            inside.set()
            release.wait(30)

    t = threading.Thread(target=first)
    t.start()
    assert inside.wait(30)
    with trace.profiler_trace("second"):
        torch.ones(2) + 1
    release.set()
    t.join(30)
    assert not t.is_alive()
    assert _traces(tmp_path / "first") and not (tmp_path / "second").exists()


def test_the_device_is_synchronised_before_the_profile_stops(tmp_path, monkeypatch):
    """On a card the traced block's kernels may still be in flight when it
    ends: ``profiler_trace`` syncs the device inside the profile, so they
    finish (and are recorded) before it stops.  It syncs before the profile
    starts too, which completes the CUPTI teardown of a profile before."""
    events = []

    class Profile:
        def __init__(self, activities, on_trace_ready):
            events.append(("activities", torch.profiler.ProfilerActivity.CUDA in activities))

        def __enter__(self):
            events.append("start")

        def __exit__(self, *exc):
            events.append("stop")

    monkeypatch.setenv("SVS_TPU_PROFILE_DIR", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: events.append("sync"))
    monkeypatch.setattr(torch.profiler, "profile", Profile)
    with trace.profiler_trace("synced"):
        events.append("block")
    assert events == ["sync", ("activities", True), "start", "block", "sync", "stop"]
    events.clear()
    with pytest.raises(RuntimeError):
        with trace.profiler_trace("failed"):
            raise RuntimeError("a failing block still syncs")
    assert events[-2:] == ["sync", "stop"]



@pytest.mark.parametrize("preset, expected", [(None, "1"), ("0", "0")])
def test_importing_trace_asks_kineto_to_tear_down_cupti(preset, expected):
    """A kept CUPTI drops kernel records from later profiles on some cards:
    importing the package sets ``TEARDOWN_CUPTI=1`` for the process (before
    any profile, as Kineto may read it once), and keeps a value the caller
    set."""
    import os
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if k != "TEARDOWN_CUPTI"}
    if preset is not None:
        env["TEARDOWN_CUPTI"] = preset
    code = "import os, svs_tpu_torch; print(os.environ.get('TEARDOWN_CUPTI'))"
    got = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    assert got.stdout.strip().splitlines()[-1] == expected
