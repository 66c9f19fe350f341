"""Command-line interface of the PyTorch port: ``svs-tpu-torch <command>``
(or ``python -m svs_tpu_torch``).

Commands:
    info   <db>             - describe a knowledge base
    pack   <db>             - pre-pack the corpus and write the sidecar
    query  <db> <text>      - retrieve top-n documents for a query
    pairs  <db>             - top pairwise-similar documents
    reembed <db> <out>      - rebuild a KB with another embedding provider
    selfcheck <db>          - integrity audit incl. device-vs-oracle parity
    gzip   <db>             - publish the shareable .gz artifact
    warm   <db>             - pack, warm the serve batch shapes, settle uploads
    serve  <db>             - HTTP server with request micro-batching
    bench  [...]            - the port's benchmark (not written yet)

Every command that opens a KB runs on ``--device`` (default ``cuda``;
``cpu`` runs the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, List, Optional


def _open_kb(args: argparse.Namespace, **kw: Any) -> "Any":
    from .kb import KB

    kw.setdefault("precision", getattr(args, "precision", "auto"))
    kw.setdefault("sidecar", "auto")
    return KB(args.db, device=args.device, **kw)


def cmd_info(args: argparse.Namespace) -> int:
    from .store.db import Database
    import asyncio

    from .utils import resolve_to_local_uncompressed_file

    path = asyncio.run(resolve_to_local_uncompressed_file(args.db))
    # describe must stay read-only: Database() would CREATE a missing
    # file, leaving a stray empty .sqlite and printing fabricated stats
    # for a typo'd path
    from pathlib import Path as _P

    if not _P(path).exists():
        print(f"error: no such database: {args.db}", file=sys.stderr)
        return 1
    db = Database(path)
    try:
        with db.transaction() as tx:
            try:
                schema_version = int(tx.get_key("schema_version"))
            except KeyError:
                schema_version = None
            info = {
                "path": str(path),
                "schema_version": schema_version,
                "docs": tx.count_docs(),
                "embeddings": tx.count_embeddings(),
                "embedding_dim": tx.embedding_dim(),
                "edges": tx.count_edges(),
                "user_keys": tx.count_keys_user(),
                "matrix_version": tx.matrix_version(),
            }
            try:
                info["embedding_func_params"] = json.loads(
                    tx.get_key("embedding_func_params")
                )
            except KeyError:
                info["embedding_func_params"] = None
        print(json.dumps(info, indent=2))
        return 0
    finally:
        db.close()


def cmd_pack(args: argparse.Namespace) -> int:
    kb = _open_kb(args, sidecar=True)
    try:
        kb.load()
        corpus = kb.engine.corpus
        assert corpus is not None
        print(
            f"packed {corpus.n_valid} docs x {corpus.dim} dims "
            f"({corpus.precision}, {corpus.nbytes_device() / 1e6:.1f} MB "
            f"on device); sidecar written"
        )
        return 0
    finally:
        kb.close()


def _parse_meta_filter(
    raw: "str | None",
) -> "tuple[object | None, int | None]":
    """``(where, None)`` for a valid --meta-filter JSON object (or no
    flag), ``(None, 2)`` after printing the error for malformed input."""
    if not raw:
        return None, None
    import json as _json

    try:
        flt = _json.loads(raw)
    except ValueError as exc:
        print(f"--meta-filter is not valid JSON: {exc}", file=sys.stderr)
        return None, 2
    if not isinstance(flt, dict):
        print("--meta-filter must be a JSON object", file=sys.stderr)
        return None, 2
    from .kb import meta_filter_predicate

    return meta_filter_predicate(flt), None


def cmd_query(args: argparse.Namespace) -> int:
    where, err = _parse_meta_filter(args.meta_filter)
    if err is not None:
        return err
    kb = _open_kb(args)
    try:
        hits = kb.retrieve(args.text, args.n, where=where)
        for hit in hits:
            doc = hit["doc"]
            print(f"{hit['score']:+.6f}  #{doc['id']}  {doc['text'][:120]}")
        return 0
    finally:
        kb.close()


def cmd_pairs(args: argparse.Namespace) -> int:
    where, err = _parse_meta_filter(args.meta_filter)
    if err is not None:
        return err
    kb = _open_kb(args)
    try:
        for score, d1, d2 in kb.document_top_pairwise_scores(
            args.n, where=where
        ):
            print(
                f"{score:+.6f}  #{d1['id']} ~ #{d2['id']}  "
                f"{d1['text'][:50]!r} ~ {d2['text'][:50]!r}"
            )
        return 0
    finally:
        kb.close()


def cmd_reembed(args: argparse.Namespace) -> int:
    from .embeddings import make_embeddings_func
    from .tools import reembed
    import json as _json

    params = _json.loads(args.provider_params)
    count = reembed(
        args.db, args.out, make_embeddings_func(params, device=args.device),
        device=args.device,
    )
    print(f"re-embedded {count} documents -> {args.out}")
    return 0


def cmd_selfcheck(args: argparse.Namespace) -> int:
    from .tools import selfcheck

    try:
        report = selfcheck(
            args.db,
            queries=args.queries,
            n=args.n,
            precision=args.precision,
            seed=args.seed,
            device=args.device,
        )
    except FileNotFoundError:
        print(f"error: no such database: {args.db}", file=sys.stderr)
        return 1
    print(json.dumps(report, indent=2))
    return 0 if report["ok"] else 1


def cmd_gzip(args: argparse.Namespace) -> int:
    kb = _open_kb(args)
    # the artifact lands next to the RESOLVED local file (a .gz or URL
    # input resolves to the extracted/downloaded .sqlite), not at
    # f"{args.db}.gz" — print the real path so scripts can use it
    assert kb.db is not None
    out = f"{kb.db.path}.gz"
    kb.close(vacuum=True, also_gzip=True)
    print(f"wrote {out}")
    return 0


def cmd_warm(args: argparse.Namespace) -> int:
    """Bring a node to steady state before putting it in service: pack
    (sidecar when present), run the search pipeline at the requested
    batch shapes (the kernels build at first use), and wait out the
    background pack/mirror uploads and the dispatch-calibration probes
    the shapes spawned, whose winners persist in the calibration cache
    (``SVS_TPU_CALIB_CACHE``, default
    ``~/.cache/svs_tpu_torch/dispatch.json``) for the processes that
    serve next."""
    import time as _time

    from .serve import warm_bucket_ladder

    batches = (
        [int(b) for b in args.batches.split(",")]
        if args.batches else warm_bucket_ladder(args.max_batch)
    )
    t0 = _time.perf_counter()
    kb = _open_kb(args, sidecar=True)
    kb.load()
    print(f"pack: {_time.perf_counter() - t0:.1f}s")
    t0 = _time.perf_counter()
    kb.warmup(batches, n=args.n)
    print(f"warmup ({len(batches)} batch shapes x2 rounds): "
          f"{_time.perf_counter() - t0:.1f}s")
    t0 = _time.perf_counter()
    ok = kb.engine.wait_for_mirror(args.timeout)
    print(f"uploads settled: {ok} ({_time.perf_counter() - t0:.1f}s)")
    # the probes persist their winners as they land (no output of their own)
    ok = kb.engine.join_dispatch_probes(args.timeout) and ok
    kb.close(write_sidecar=None)
    return 0 if ok else 1


def _replica_devices(device: str, n: int) -> List[str]:
    """The devices of ``--replicas N``: N CUDA devices from the named one
    (``cuda`` is ``cuda:0``), or N copies of a device that is not CUDA (the
    CPU).  Raises the replica engine's ``ValueError`` where the machine
    has fewer.  The count comes from ``torch.cuda.device_count()``, which
    reads NVML where it can and so leaves CUDA uninitialised for the
    workers' fork."""
    import torch

    if n < 1:
        raise ValueError("n_replicas must be >= 1")
    dev = torch.device(device)
    if dev.type != "cuda":
        return [str(dev)] * n
    first = dev.index or 0
    have = max(0, torch.cuda.device_count() - first)
    if n > have:
        raise ValueError(f"n_replicas={n} but only {have} devices available")
    return [f"cuda:{first + i}" for i in range(n)]


def cmd_serve(args: argparse.Namespace) -> int:
    from .serve import run_server

    placement: dict = {"device": args.device}
    if args.replicas is not None:
        try:
            placement = {"replicas": _replica_devices(args.device, args.replicas)}
        except ValueError as exc:
            # more replicas than devices: the replica engine's message
            print(f"error: {exc}", file=sys.stderr)
            return 2
    run_server(
        args.db,
        host=args.host,
        port=args.port,
        writable=args.writable,
        max_batch=args.max_batch,
        window_ms=args.batch_window_ms,
        max_queue=args.max_queue,
        warm=not args.no_warm,
        workers=args.workers,
        precision=args.precision,
        sidecar="auto",
        **placement,
    )
    return 0


def cmd_bench(argv: List[str]) -> int:
    # bench.py measures the JAX package (it imports JAX): the port's own
    # benchmark is still to be written
    print(
        "error: the port's benchmark (bench_torch.py) does not exist yet; "
        "python3 chip_smoke.py is the port's end-to-end check on a GPU",
        file=sys.stderr,
    )
    return 1


def main(argv: "Optional[List[str]]" = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "bench":
        return cmd_bench(argv[1:])

    parser = argparse.ArgumentParser(
        prog="svs-tpu-torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = parser.add_subparsers(dest="command", required=True)

    def device_flag(p: argparse.ArgumentParser) -> None:
        p.add_argument("--device", default="cuda",
                       help="torch device the KB runs on (default: cuda; "
                       "cpu runs the kernels' plain versions)")

    p = sub.add_parser("info", help="describe a knowledge base")
    p.add_argument("db")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("pack", help="pre-pack the corpus + write sidecar")
    p.add_argument("db")
    p.add_argument("--precision", choices=["auto", "f32", "bf16", "int8"],
                   default="auto")
    device_flag(p)
    p.set_defaults(fn=cmd_pack)

    p = sub.add_parser("query", help="retrieve top-n documents")
    p.add_argument("db")
    p.add_argument("text")
    p.add_argument("-n", type=int, default=10)
    p.add_argument("--precision", choices=["auto", "f32", "bf16", "int8"],
                   default="auto")
    device_flag(p)
    p.add_argument("--meta-filter", default=None, metavar="JSON",
                   help="JSON object of meta-key -> required-value "
                   "equalities (exact filtered retrieval)")
    p.set_defaults(fn=cmd_query)

    p = sub.add_parser("pairs", help="top pairwise-similar documents")
    p.add_argument("db")
    p.add_argument("-n", type=int, default=10)
    p.add_argument("--meta-filter", default=None, metavar="JSON",
                   help="JSON object of meta-key -> required-value "
                   "equalities (pairs among matching documents only)")
    device_flag(p)
    p.set_defaults(fn=cmd_pairs)

    p = sub.add_parser(
        "reembed", help="rebuild a KB with a different embedding provider"
    )
    p.add_argument("db")
    p.add_argument("out")
    p.add_argument(
        "--provider-params",
        required=True,
        help='JSON, e.g. \'{"provider": "mock"}\' (the port carries only '
        "the mock provider so far)",
    )
    device_flag(p)
    p.set_defaults(fn=cmd_reembed)

    p = sub.add_parser(
        "selfcheck",
        help="integrity audit: store invariants, embedding integrity, "
        "sidecar freshness, device-vs-oracle retrieval parity",
    )
    p.add_argument("db")
    p.add_argument("-q", "--queries", type=int, default=8,
                   help="stored vectors replayed through the full "
                   "retrieval pipeline for the parity check")
    p.add_argument("-n", type=int, default=10,
                   help="top-n compared per replayed query")
    p.add_argument("--precision", choices=["auto", "f32", "bf16", "int8"],
                   default="auto")
    device_flag(p)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_selfcheck)

    p = sub.add_parser("gzip", help="publish the .gz artifact")
    p.add_argument("db")
    device_flag(p)
    p.set_defaults(fn=cmd_gzip)

    p = sub.add_parser(
        "warm",
        help="run the serve batch shapes once + settle uploads (run "
        "before putting a node in service; persists the dispatch "
        "calibration probes)",
    )
    p.add_argument("db")
    p.add_argument("--batches", default=None,
                   help="comma-separated batch sizes (default: the serve "
                   "bucket ladder up to --max-batch)")
    p.add_argument("--max-batch", type=int, default=256)
    p.add_argument("-n", type=int, default=16,
                   help="top-n to warm (sets the candidate-width hint)")
    p.add_argument("--timeout", type=float, default=900.0)
    p.add_argument("--precision", choices=["auto", "f32", "bf16", "int8"],
                   default="auto")
    device_flag(p)
    p.set_defaults(fn=cmd_warm)

    p = sub.add_parser(
        "serve",
        help="serve the KB over HTTP with request micro-batching",
    )
    p.add_argument("db")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--writable", action="store_true",
                   help="allow POST /add (default: read-only)")
    p.add_argument("--max-batch", type=int, default=256,
                   help="max queries per device step")
    p.add_argument("--batch-window-ms", type=float, default=2.0,
                   help="micro-batch coalescing window")
    p.add_argument("--max-queue", type=int, default=None,
                   help="pending-request bound before 429 shedding "
                   "(default: 16 x max-batch)")
    p.add_argument("--precision", choices=["auto", "f32", "bf16", "int8"],
                   default="auto")
    device_flag(p)
    p.add_argument("--replicas", type=int, default=None,
                   help="replicate the corpus to N devices and split each "
                   "micro-batch across them (throughput mode; corpus must "
                   "fit one device): N CUDA devices from --device's (cuda "
                   "is cuda:0); with --device cpu, N copies on the CPU")
    p.add_argument("--no-warm", action="store_true",
                   help="skip warming the batcher's batch shapes at "
                   "startup (early requests then pay the kernels' first use)")
    p.add_argument("--workers", type=int, default=1,
                   help="fork N serving processes sharing the port via "
                   "SO_REUSEPORT — scales the HOST side (HTTP/JSON/"
                   "hydration) with cores; each worker holds its own "
                   "pack on the device, see serve.run_server docs")
    p.set_defaults(fn=cmd_serve)

    sub.add_parser("bench", help="the port's benchmark (not written yet: exits 1)")

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except NotImplementedError as exc:
        # a part of svs_tpu the port does not carry (a local model type
        # such as roformer, a tokenizer file or component): the message
        # names it
        print(f"error: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
