"""The port's command line (``svs_tpu_torch.cli``) against ``svs_tpu.cli``
on the CPU: the cases of the reference's ``tests/test_cli.py`` (and the
CLI cases of ``tests/test_tools.py``) run through both ``main``s, each on
its own copy of one store, with ``--device cpu`` for the port; stdout,
stderr and exit codes must be equal (paths and timings aside).  Then
what the port does on its own: ``--device``, ``bench`` (no benchmark yet:
it never runs the JAX ``bench.py``), ``serve --replicas`` (copies of the
corpus on the CPU answer; more replicas than CUDA devices exit 2 with the
reference's message) and a local model type that is not ported (exit 2,
no traceback); and ``info`` / ``query`` on stores of the openai, ollama
and local providers."""

import http.client
import json
import re
import shutil
import signal
import socket
import sqlite3
import subprocess
import sys
import time
from pathlib import Path

import jax
import pytest
import torch

import svs_tpu
import svs_tpu.cli as ref_cli
import svs_tpu.parallel.replicas as ref_replicas
import svs_tpu_torch
import svs_tpu_torch.cli as port_cli

from kb_helpers import make_onehot_embedder
from torch_provider_helpers import StubServer, write_tiny_bert

torch.set_num_threads(2)

#: Subcommands that open a KB, and so take ``--device``.
_DEVICE_COMMANDS = {"pack", "query", "pairs", "reembed", "selfcheck", "gzip", "warm"}


def _run(cli, argv, capsys):
    if cli is port_cli and argv[0] in _DEVICE_COMMANDS:
        argv = [*argv, "--device", "cpu"]
    rc = cli.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _both(tmp_path, capsys, argv, db_name="db.sqlite"):
    """``argv`` (``{db}`` / ``{dir}`` replaced per package) through both
    CLIs, each on its own copy of ``tmp_path / db_name``; returns
    ``[(rc, out, err)]`` for svs_tpu, then the port, with the copies' paths
    written back as ``{db}`` / ``{dir}``."""
    src = tmp_path / db_name
    got = []
    for name, cli in (("ref", ref_cli), ("port", port_cli)):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        db = d / db_name
        if src.exists():
            shutil.copy(src, db)
        args = [a.replace("{db}", str(db)).replace("{dir}", str(d)) for a in argv]
        rc, out, err = _run(cli, args, capsys)
        got.append((rc, out.replace(str(db), "{db}").replace(str(d), "{dir}"),
                    err.replace(str(db), "{db}").replace(str(d), "{dir}")))
    return got


def _same(tmp_path, capsys, argv, db_name="db.sqlite"):
    ref, port = _both(tmp_path, capsys, argv, db_name)
    assert port == ref
    return ref


@pytest.fixture
def populated(tmp_path):
    kb = svs_tpu.KB(tmp_path / "db.sqlite", svs_tpu.make_mock_embeddings_func())
    with kb.bulk_add_docs() as add:
        ids = [add(f"doc {i}") for i in range(4)]
    with kb.bulk_graph_update() as g:
        g.add_edge(ids[0], ids[1], ids[2])
    kb.close()
    return tmp_path


def test_info(populated, capsys):
    rc, out, _ = _same(populated, capsys, ["info", "{db}"])
    info = json.loads(out)
    assert rc == 0 and info["docs"] == 4 and info["embeddings"] == 4
    assert info["embedding_dim"] == 3 and info["edges"] == 1
    assert info["embedding_func_params"] == {"provider": "mock"}
    rc, _, err = _same(populated, capsys, ["info", "{dir}/missing.sqlite"])
    assert rc == 1 and "no such database" in err


def test_query(populated, capsys):
    rc, out, _ = _same(populated, capsys, ["query", "{db}", "anything", "-n", "2"])
    lines = out.strip().splitlines()
    assert rc == 0 and len(lines) == 2 and lines[0].startswith("+1.000000")


def test_query_meta_filter(tmp_path, capsys):
    kb = svs_tpu.KB(tmp_path / "db.sqlite", svs_tpu.make_mock_embeddings_func())
    with kb.bulk_add_docs() as add:
        for i in range(6):
            add(f"doc {i}", meta={"lang": "de" if i % 2 else "en"})
    kb.close()
    rc, out, _ = _same(tmp_path, capsys, ["query", "{db}", "x", "-n", "6",
                                          "--meta-filter", '{"lang": "de"}'])
    assert rc == 0 and len(out.strip().splitlines()) == 3
    for bad in ('["lang"]', '{"lang": de}'):
        rc, out, err = _same(tmp_path, capsys, ["query", "{db}", "x", "--meta-filter", bad])
        assert rc == 2 and not out and "Traceback" not in err


def test_pack_writes_sidecar(populated, capsys):
    rc, out, _ = _same(populated, capsys, ["pack", "{db}"])
    assert rc == 0 and "sidecar written" in out
    from svs_tpu_torch.engine.sidecar import sidecar_path_for

    assert sidecar_path_for(populated / "port" / "db.sqlite").exists()


def test_pairs(populated, capsys):
    rc, out, _ = _same(populated, capsys, ["pairs", "{db}", "-n", "3"])
    assert rc == 0 and len(out.strip().splitlines()) == 3


def test_gzip(populated, capsys):
    rc, out, _ = _same(populated, capsys, ["gzip", "{db}"])
    assert rc == 0 and out == "wrote {db}.gz\n"
    assert (populated / "port" / "db.sqlite.gz").exists()


def test_pairs_meta_filter(tmp_path, capsys):
    kb = svs_tpu.KB(tmp_path / "db.sqlite", svs_tpu.make_mock_embeddings_func())
    with kb.bulk_add_docs() as add:
        for i in range(8):
            add(f"doc {i}", meta={"lang": "de" if i % 2 else "en"})
    kb.close()
    rc, out, _ = _same(tmp_path, capsys, ["pairs", "{db}", "-n", "100",
                                          "--meta-filter", '{"lang": "de"}'])
    assert rc == 0 and len(out.strip().splitlines()) == 4 * 3 // 2
    rc, _, _ = _same(tmp_path, capsys, ["pairs", "{db}", "--meta-filter", "nope"])
    assert rc == 2


def test_cli_warm(tmp_path, capsys):
    kb = svs_tpu.KB(tmp_path / "db.sqlite", make_onehot_embedder(), force_fresh_db=True)
    with kb.bulk_add_docs() as add:
        for i in range(12):
            add(f"vec:{i}")
    kb.close()
    ref, port = _both(tmp_path, capsys, ["warm", "{db}", "--batches", "1,2", "-n", "4"])

    def untimed(out):
        return re.sub(r"\d+\.\ds", "<s>", out)

    assert port[0] == ref[0] == 0
    assert untimed(port[1]) == untimed(ref[1])
    assert "warmup (2 batch shapes" in port[1]
    assert "uploads settled: True" in port[1]


def test_cli_reembed(tmp_path, capsys):
    kb = svs_tpu.KB(tmp_path / "db.sqlite", make_onehot_embedder())
    with kb.bulk_add_docs() as add:
        add("vec:1"), add("vec:2")
    kb.close()
    rc, out, _ = _same(tmp_path, capsys, [
        "reembed", "{db}", "{dir}/out.sqlite", "--provider-params", '{"provider": "mock"}',
    ])
    assert rc == 0 and "re-embedded 2 documents" in out
    dest = svs_tpu_torch.KB(tmp_path / "port" / "out.sqlite", device="cpu")
    assert len(dest) == 2
    dest.close()


def _selfcheck_db(tmp_path):
    from kb_helpers import make_angle_embedder

    kb = svs_tpu.KB(tmp_path / "db.sqlite", make_angle_embedder())
    with kb.bulk_add_docs() as add:
        root = add("angle:0", meta={"kind": "root"})
        for i in range(1, 30):
            add(f"angle:{i * 7 % 360}", parent_id=root if i % 3 else None)
    kb.close()


def test_selfcheck_cli_exit_codes(tmp_path, capsys):
    _selfcheck_db(tmp_path)
    rc, out, _ = _same(tmp_path, capsys, ["selfcheck", "{db}", "-q", "2", "-n", "3"])
    assert rc == 0 and json.loads(out)["ok"]
    conn = sqlite3.connect(tmp_path / "db.sqlite")
    conn.execute("UPDATE docs SET level = 9 WHERE parent_id IS NULL;")
    conn.commit()
    conn.close()
    rc, out, _ = _same(tmp_path, capsys, ["selfcheck", "{db}", "-q", "0"])
    assert rc == 1 and not json.loads(out)["checks"]["levels"]["ok"]
    rc, _, err = _same(tmp_path, capsys, ["selfcheck", "{dir}/missing.sqlite"])
    assert rc == 1 and "no such database" in err


def test_cli_serve_accepts_workers(monkeypatch):
    seen = {}
    monkeypatch.setattr("svs_tpu_torch.serve.run_server",
                        lambda db, **kw: seen.update(kw, db=db))
    assert port_cli.main(["serve", "/tmp/x.sqlite", "--workers", "3"]) == 0
    assert seen["workers"] == 3 and seen["db"] == "/tmp/x.sqlite"
    # the device is named, never resolved, before the workers fork
    assert seen["device"] == "cuda"
    assert port_cli.main(["serve", "/tmp/x.sqlite", "--device", "cpu",
                          "--max-batch", "64", "--no-warm"]) == 0
    assert seen["device"] == "cpu" and seen["max_batch"] == 64 and seen["warm"] is False
    assert seen["workers"] == 1 and seen["window_ms"] == 2.0 and seen["max_queue"] is None


@pytest.mark.parametrize("command", sorted(_DEVICE_COMMANDS | {"serve"}))
def test_device_flag_defaults_to_cuda(command):
    argv = {"reembed": ["a", "b", "--provider-params", "{}"],
            "query": ["a", "text"]}.get(command, ["a"])
    parsed = {}

    def capture(args):
        parsed.update(vars(args))
        return 0

    import argparse

    real = argparse.ArgumentParser.parse_args

    def parse(self, args=None, namespace=None):
        ns = real(self, args, namespace)
        ns.fn = capture
        return ns

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", parse)
        assert port_cli.main([command, *argv]) == 0
        assert parsed["device"] == "cuda"
        assert port_cli.main([command, *argv, "--device", "cpu"]) == 0
        assert parsed["device"] == "cpu"


def test_bench_says_there_is_no_port_benchmark(monkeypatch, capsys):
    import runpy

    def never(*a, **kw):
        raise AssertionError("the port's CLI ran bench.py")

    monkeypatch.setattr(runpy, "run_path", never)
    assert port_cli.main(["bench", "--preset", "smoke"]) == 1
    err = capsys.readouterr().err
    assert "bench_torch.py" in err and "does not exist yet" in err


def test_replicas_and_unported_provider_exit_2(tmp_path, capsys):
    # more replicas than the machine has CUDA devices: the replica engine's
    # message (the JAX package's text), exit 2, no traceback
    n = torch.cuda.device_count() + 1
    assert port_cli.main(["serve", str(tmp_path / "x.sqlite"), "--replicas", str(n)]) == 2
    err = capsys.readouterr().err
    want = f"n_replicas={n} but only {n - 1} devices available"
    with pytest.raises(ValueError, match=want):
        ref_replicas.ReplicaEngine(n_replicas=n, devices=jax.devices()[: n - 1])
    assert want in err and "Traceback" not in err
    # a store written with a local provider whose model type the port does
    # not carry (every provider is ported; roformer's encoder is not)
    ck = write_tiny_bert(tmp_path / "roformer", model_type="roformer")
    kb = svs_tpu_torch.KB(tmp_path / "o.sqlite", make_onehot_embedder(), device="cpu")
    with kb.bulk_add_docs() as add:
        add("vec:1")
    kb.close()
    params = json.dumps({"provider": "local", "model": str(ck)})
    conn = sqlite3.connect(tmp_path / "o.sqlite")
    conn.execute("UPDATE keyval SET val = ? WHERE key = 'embedding_func_params';", (params,))
    conn.commit()
    conn.close()
    for argv in (["query", str(tmp_path / "o.sqlite"), "x", "--device", "cpu"],
                 ["reembed", str(tmp_path / "o.sqlite"), str(tmp_path / "p.sqlite"),
                  "--provider-params", params, "--device", "cpu"]):
        assert port_cli.main(argv) == 2
        err = capsys.readouterr().err
        assert "not ported" in err and "roformer" in err and "Traceback" not in err


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.mark.parametrize(
    "device, n, want",
    [
        ("cuda", 4, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
        ("cuda:1", 2, ["cuda:1", "cuda:2"]),
        ("cuda:2", 3, "n_replicas=3 but only 2 devices available"),
        ("cuda", 5, "n_replicas=5 but only 4 devices available"),
        ("cpu", 3, ["cpu", "cpu", "cpu"]),
        ("cpu", 0, "n_replicas must be >= 1"),
    ],
)
def test_cli_replica_devices(monkeypatch, capsys, tmp_path, device, n, want):
    """``--replicas N`` takes N CUDA devices from ``--device``'s index (on a
    4-card host), or N copies of the CPU; too few devices is the replica
    engine's message, exit 2, checked before the server starts (a
    ``ValueError`` from serving is not turned into that exit)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    if isinstance(want, list):
        assert port_cli._replica_devices(device, n) == want
        return
    with pytest.raises(ValueError, match=want):
        port_cli._replica_devices(device, n)

    def no_server(*a, **k):
        raise AssertionError("the server started")

    import svs_tpu_torch.serve as serve_mod

    monkeypatch.setattr(serve_mod, "run_server", no_server)
    argv = ["serve", str(tmp_path / "x.sqlite"), "--replicas", str(n), "--device", device]
    assert port_cli.main(argv) == 2
    err = capsys.readouterr().err
    assert want in err and "Traceback" not in err


def test_cli_serve_value_error_is_not_a_replica_error(monkeypatch, tmp_path):
    """A ``ValueError`` raised while the server runs propagates: only the
    replica count's error becomes exit 2."""
    import svs_tpu_torch.serve as serve_mod

    def bad_server(*a, **k):
        raise ValueError("bad store")

    monkeypatch.setattr(serve_mod, "run_server", bad_server)
    with pytest.raises(ValueError, match="bad store"):
        port_cli.main(["serve", str(tmp_path / "x.sqlite"), "--replicas", "1",
                       "--device", "cpu"])


@pytest.mark.parametrize("replicas", [1, 2])
def test_cli_serve_replicas_on_the_cpu_answers(tmp_path, replicas):
    """``serve --replicas N --device cpu``: N copies of the corpus on the
    CPU; the server answers a batch (split across the replicas) with the
    reference tie order, and exits 0 on SIGTERM."""
    db = tmp_path / "served.sqlite"
    kb = svs_tpu_torch.KB(db, svs_tpu_torch.make_mock_embeddings_func(),
                          force_fresh_db=True, device="cpu")
    with kb.bulk_add_docs() as add:
        for i in range(6):
            add(f"doc {i}")
    kb.close()
    port = _free_port()
    log = tmp_path / "serve.log"
    with open(log, "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "svs_tpu_torch", "serve", str(db), "--device", "cpu",
             "--replicas", str(replicas), "--port", str(port), "--max-batch", "4"],
            cwd=Path(svs_tpu_torch.__file__).resolve().parent.parent,
            stdout=out, stderr=subprocess.STDOUT,
        )
    try:
        deadline = time.monotonic() + 90
        while True:
            assert proc.poll() is None, log.read_text()
            try:
                c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
                c.request("GET", "/healthz")
                r = c.getresponse()
                assert r.status == 200 and json.loads(r.read())["docs"] == 6
                break
            except OSError:
                assert time.monotonic() < deadline, log.read_text()
                time.sleep(0.2)
        c.request("POST", "/retrieve", body=json.dumps({"queries": ["a", "b", "c"], "n": 2}))
        r = c.getresponse()
        results = json.loads(r.read())["results"]
        assert r.status == 200
        assert [[h["doc"]["text"] for h in hits] for hits in results] == [["doc 5", "doc 4"]] * 3
        c.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, log.read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)


def _query_lines(out):
    rows = [line.split(None, 2) for line in out.strip().splitlines()]
    return [r[1] for r in rows], [float(r[0]) for r in rows]


@pytest.mark.parametrize("provider", ["openai", "ollama", "local"])
def test_info_and_query_on_provider_stores(tmp_path, capsys, monkeypatch, provider):
    """``info`` and ``query`` on a store written by ``svs_tpu`` with each
    provider, through both CLIs: the port rebuilds the provider from the
    stored params (openai / ollama against a loopback stub, the local
    encoder on the CPU) and prints the reference's info and hits."""
    import svs_tpu.embeddings as ref_emb

    pytest.importorskip("aiohttp" if provider != "local" else "transformers")
    srv = StubServer(embed_dim=24)
    try:
        monkeypatch.setenv("OPENAI_BASE_URL", f"{srv.url}/v1/embeddings")
        monkeypatch.setenv("OPENAI_API_KEY", "sk-cli")
        monkeypatch.setenv("OLLAMA_BASE_URL", srv.url)
        if provider == "openai":
            fn = ref_emb.make_openai_embeddings_func(dimensions=24)
        elif provider == "ollama":
            fn = ref_emb.make_ollama_embeddings_func("nomic", base_url=srv.url)
        else:
            ck = write_tiny_bert(tmp_path / "ck")
            fn = ref_emb.make_local_embeddings_func(str(ck), max_length=16, compute_dtype="float32")
        kb = svs_tpu.KB(tmp_path / "db.sqlite", fn)
        with kb.bulk_add_docs() as add:
            for text in ["the cat sat", "a dog ran fast", "red mat", "blue dog", "sad cat"]:
                add(text)
        kb.close()
        capsys.readouterr()  # the reference's writes may warn (transformers)
        ref, port = _both(tmp_path, capsys, ["info", "{db}"])
        assert port[:2] == ref[:2] and port[0] == 0 and port[2] == ""
        assert json.loads(port[1])["embedding_func_params"]["provider"] == provider
        ref, port = _both(tmp_path, capsys, ["query", "{db}", "the cat", "-n", "3"])
        assert port[0] == ref[0] == 0 and "Traceback" not in port[2]
        (got_ids, got_scores), (want_ids, want_scores) = _query_lines(port[1]), _query_lines(ref[1])
        assert got_ids == want_ids and len(got_ids) == 3
        assert max(abs(a - b) for a, b in zip(got_scores, want_scores)) <= 2e-6
    finally:
        srv.close()
