"""The PyTorch port stands alone: it imports with JAX and the JAX
package's optional dependencies blocked (int8 and bf16 storage, batches
above 256, top document pairs, metadata filters and ``AsyncKB``, the
deferred upload, the host route and the native library, the HTTP server,
the CLI and the tools; the embedding providers, the dispatch calibration
and the trace export, with ``transformers``, ``flax``, ``msgpack`` and
``aiohttp`` blocked too; meshes and replicas, with ``svs_tpu`` itself
blocked; the local provider past BERT, ALBERT, BigBird, the decoders
(Llama / Mistral / Gemma, GPT-2, GPT-Neo, GPT-J, BLOOM, XGLM) and the
encoder-decoders (BART, mBART, Pegasus, Blenderbot, Blenderbot-small) included,
with ``tokenizers``, ``sentencepiece`` and ``regex`` blocked too; the
benchmark probes, with ``benchmarks`` blocked too), never imports
``svs_tpu``, and refuses to fall back to the CPU when no device was
named (the ``KB`` and the probes' entry points)."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import svs_tpu_torch

_BLOCKED_ROUND_TRIP = textwrap.dedent(
    """
    import sys

    BLOCKED = ("jax", "jaxlib", "networkx", "ml_dtypes", "aiohttp", "dotenv")

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked in this test")
            return None

    sys.meta_path.insert(0, Blocker())

    import svs_tpu_torch
    from svs_tpu_torch import KB, make_mock_embeddings_func

    path = sys.argv[1]
    kb = KB(path, make_mock_embeddings_func(), force_fresh_db=True, device="cpu")
    with kb.bulk_add_docs() as add:
        ids = [add(f"doc {i}") for i in range(5)]
    hits = kb.retrieve("anything", 3)
    assert len(hits) == 3, hits
    # the mock embeds every text alike: all scores tie at 1.0 and the
    # reference tie rule returns the largest embedding ids first
    assert [h["doc"]["id"] for h in hits] == ids[::-1][:3], hits
    assert all(abs(h["score"] - 1.0) < 1e-6 for h in hits)
    kb.close()
    # reopen: the embedding function is restored from the database
    kb = KB(path, device="cpu")
    assert len(kb) == 5
    kb.close()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED + ("svs_tpu",))
    assert not loaded, loaded
    print("ROUND_TRIP_OK")
    """
)


_BLOCKED_BF16_WIDE_BATCH = textwrap.dedent(
    """
    import sys, zlib

    BLOCKED = ("jax", "jaxlib", "networkx", "ml_dtypes", "aiohttp", "dotenv")

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked in this test")
            return None

    sys.meta_path.insert(0, Blocker())

    import numpy as np
    from svs_tpu_torch import KB

    def vec(text):
        rng = np.random.default_rng(zlib.crc32(text.encode()))
        v = rng.standard_normal(32).astype(np.float32)
        return v / np.linalg.norm(v)

    async def embed(texts):
        return [vec(t).tolist() for t in texts]

    path = sys.argv[1]
    kb = KB(path, embed, force_fresh_db=True, precision="bf16", device="cpu")
    with kb.bulk_add_docs() as add:
        ids = [add(f"doc {i}") for i in range(300)]
    queries = [f"query {i}" for i in range(300)]
    hits = kb.retrieve_batch(queries, 5)
    assert kb.engine.precision == "bf16"
    kb.close()
    # exact: the f32 top-5 of every query, ties to the larger id
    m = np.stack([vec(f"doc {i}") for i in range(300)])
    for q, got in zip(queries, hits):
        s = m @ vec(q)
        want = sorted(range(300), key=lambda j: (-s[j], -ids[j]))[:5]
        assert [h["doc"]["id"] for h in got] == [ids[j] for j in want], got
    kb = KB(path, embed, precision="bf16", device="cpu")
    assert len(kb) == 300
    kb.close()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED + ("svs_tpu",))
    assert not loaded, loaded
    print("ROUND_TRIP_OK")
    """
)


_BLOCKED_PAIRWISE = textwrap.dedent(
    """
    import sys, zlib

    BLOCKED = ("jax", "jaxlib", "networkx", "ml_dtypes", "aiohttp", "dotenv")

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked in this test")
            return None

    sys.meta_path.insert(0, Blocker())

    import numpy as np
    from svs_tpu_torch import KB
    from svs_tpu_torch.utils.topk_np import top_pairs_numpy

    def vec(text):
        rng = np.random.default_rng(zlib.crc32(text.encode()))
        v = rng.standard_normal(24).astype(np.float32)
        return v / np.linalg.norm(v)

    async def embed(texts):
        return [vec(t).tolist() for t in texts]

    path = sys.argv[1]
    kb = KB(path, embed, force_fresh_db=True, device="cpu")
    with kb.bulk_add_docs() as add:
        ids = [add(f"doc {i}") for i in range(4000)]
    pairs = kb.document_top_pairwise_scores(15)
    kb.close()
    # exact: the brute-force f32 top-15 pairs (the 4096-row pack takes the
    # keyed route, then the f32 rescore and the margin check)
    m = np.stack([vec(f"doc {i}") for i in range(4000)])
    want = top_pairs_numpy(m @ m.T, 15)
    assert [(a["id"], b["id"]) for _, a, b in pairs] == [
        (ids[r], ids[c]) for _, r, c in want
    ], pairs
    assert max(abs(s - w[0]) for (s, _, _), w in zip(pairs, want)) < 1e-6
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED + ("svs_tpu",))
    assert not loaded, loaded
    print("ROUND_TRIP_OK")
    """
)


_BLOCKED_FILTERS_ASYNC = textwrap.dedent(
    """
    import asyncio, sys, zlib

    BLOCKED = ("jax", "jaxlib", "networkx", "ml_dtypes", "aiohttp", "dotenv")

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked in this test")
            return None

    sys.meta_path.insert(0, Blocker())

    import numpy as np
    from svs_tpu_torch import AsyncKB, KB, meta_filter_predicate

    def vec(text):
        rng = np.random.default_rng(zlib.crc32(text.encode()))
        v = rng.standard_normal(12).astype(np.float32)
        return v / np.linalg.norm(v)

    async def embed(texts):
        return [vec(t).tolist() for t in texts]

    path = sys.argv[1]
    kb = KB(path, embed, force_fresh_db=True, device="cpu")
    with kb.bulk_add_docs() as add:
        ids = [add(f"doc {i}", meta={"g": i % 10}) for i in range(500)]
    hits = kb.retrieve("query", 5, where={"g": 3})
    pairs = kb.document_top_pairwise_scores(4, where=meta_filter_predicate({"g": 3}))
    kb.close()
    # exact: the f32 top-5 of the 50 matching docs, and their top-4 pairs
    m = np.stack([vec(f"doc {i}") for i in range(500)])
    match = [i for i in range(500) if i % 10 == 3]
    s = m[match] @ vec("query")
    assert [h["doc"]["id"] for h in hits] == [
        ids[match[j]] for j in np.argsort(-s, kind="stable")[:5]
    ], hits
    g = m[match] @ m[match].T
    iu = np.triu_indices(len(match), 1)
    top = np.argsort(-g[iu], kind="stable")[:4]
    assert [(a["id"], b["id"]) for _, a, b in pairs] == [
        (ids[match[iu[0][t]]], ids[match[iu[1][t]]]) for t in top
    ], pairs

    async def run():
        akb = AsyncKB(path, embed, device="cpu")
        try:
            return await akb.retrieve("query", 5, where={"g": 3})
        finally:
            await akb.close()

    assert asyncio.run(run()) == hits
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED + ("svs_tpu",))
    assert not loaded, loaded
    print("ROUND_TRIP_OK")
    """
)


_BLOCKED_HOST_ROUTE = textwrap.dedent(
    """
    import os, sys, zlib

    BLOCKED = ("jax", "jaxlib", "networkx", "ml_dtypes", "aiohttp", "dotenv")

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked in this test")
            return None

    sys.meta_path.insert(0, Blocker())

    import numpy as np
    import svs_tpu_torch.engine.packing as packing
    from svs_tpu_torch import KB, native
    from svs_tpu_torch.engine import RetrievalEngine

    packing.DEFER_MIN_BYTES = 0  # every pack uploads in the background
    RetrievalEngine.HOST_TWOPASS_MIN_ROWS = 64

    def vec(text):
        rng = np.random.default_rng(zlib.crc32(text.encode()))
        v = rng.standard_normal(20).astype(np.float32)
        return v / np.linalg.norm(v)

    async def embed(texts):
        return [vec(t).tolist() for t in texts]

    path = sys.argv[1]
    kb = KB(path, embed, force_fresh_db=True, device="cpu")
    kb.engine.host_dispatch = "auto"
    with kb.bulk_add_docs() as add:
        ids = [add(f"doc {i}") for i in range(800)]
    cold = kb.retrieve("query", 5)  # the host route while the pack uploads
    assert kb.stats()["host_search"]["count"] == 1
    assert kb.engine.wait_for_mirror(timeout=60)
    assert kb.engine.corpus.dev_rescore is not None
    def same(hits):
        assert [h["doc"]["id"] for h in hits] == [h["doc"]["id"] for h in cold]
        assert max(abs(a["score"] - b["score"]) for a, b in zip(hits, cold)) < 1e-6

    kb.engine.host_dispatch = "off"
    same(kb.retrieve("query", 5))
    kb.engine.host_dispatch = "force"
    same(kb.retrieve("query", 5))  # the two-pass, when native
    kb.warmup((1,), n=5, routes="both")
    m = np.stack([vec(f"doc {i}") for i in range(800)])
    s = m @ vec("query")
    assert [h["doc"]["id"] for h in cold] == [ids[j] for j in np.argsort(-s)[:5]]
    assert kb.engine.last_scan == ("native" if native.native_available() else "stream")
    kb.close()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED + ("svs_tpu",))
    assert not loaded, loaded
    print("ROUND_TRIP_OK")
    """
)


_BLOCKED_SERVE_CLI_TOOLS = textwrap.dedent(
    """
    import asyncio, http.client, json, runpy, sys, threading

    BLOCKED = ("jax", "jaxlib", "networkx", "ml_dtypes", "aiohttp", "dotenv")

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked in this test")
            return None

    sys.meta_path.insert(0, Blocker())

    import svs_tpu_torch
    import svs_tpu_torch.__main__
    from svs_tpu_torch import cli, serve, tools, util
    from svs_tpu_torch.utils import load_env

    path = sys.argv[1]
    kb = svs_tpu_torch.KB(path, svs_tpu_torch.make_mock_embeddings_func(),
                          force_fresh_db=True, device="cpu")
    with kb.bulk_add_docs() as add:
        ids = [add(f"doc {i}") for i in range(5)]
    kb.close()
    assert tools.selfcheck(path, queries=2, n=3, device="cpu")["ok"]
    assert util.get_top_k(__import__("numpy").arange(4.0), 2) == [(3.0, 3), (2.0, 2)]
    assert load_env(path + ".no-such.env") is False

    async def main():
        akb = svs_tpu_torch.AsyncKB(path, device="cpu")
        app = serve.make_app(akb)
        port = await app.start("127.0.0.1", 0)

        def client():
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            c.request("POST", "/retrieve", body=json.dumps({"query": "x", "n": 2}))
            r = c.getresponse()
            return r.status, json.loads(r.read())

        status, body = await asyncio.get_running_loop().run_in_executor(None, client)
        await app.close()
        await akb.close()
        return status, body

    status, body = asyncio.run(main())
    assert status == 200, (status, body)
    assert [h["doc"]["id"] for h in body["results"]] == ids[::-1][:2], body
    sys.argv = ["svs-tpu-torch", "--help"]
    try:
        runpy.run_module("svs_tpu_torch", run_name="__main__")
    except SystemExit as exc:
        assert exc.code == 0, exc.code
    else:
        raise AssertionError("--help did not exit")
    assert cli.main(["info", path]) == 0
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED + ("svs_tpu",))
    assert not loaded, loaded
    print("ROUND_TRIP_OK")
    """
)


_BLOCKED_PROVIDERS = textwrap.dedent(
    """
    import asyncio, os, sys

    BLOCKED = ("jax", "jaxlib", "networkx", "ml_dtypes", "aiohttp", "dotenv",
               "transformers", "flax", "msgpack", "tokenizers", "safetensors")

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked in this test")
            return None

    sys.meta_path.insert(0, Blocker())

    import numpy as np
    import svs_tpu_torch
    from svs_tpu_torch import KB, make_local_embeddings_func, make_openai_embeddings_func
    from svs_tpu_torch import make_ollama_embeddings_func
    from svs_tpu_torch.embeddings import bert, checkpoint, http, wordpiece
    from svs_tpu_torch.engine import calibrate
    from svs_tpu_torch.utils import trace
    from tests.torch_provider_helpers import StubServer, write_tiny_bert

    path = sys.argv[1]
    ck = write_tiny_bert(os.path.dirname(path) + "/ck")
    f = make_local_embeddings_func(str(ck), max_length=16, compute_dtype="float32", device="cpu")
    vecs = np.asarray(asyncio.run(f(["the cat sat", "a dog ran"])))
    assert vecs.shape == (2, 32) and np.allclose(np.linalg.norm(vecs, axis=1), 1, atol=1e-5)
    kb = KB(path, f, force_fresh_db=True, device="cpu")
    with kb.bulk_add_docs() as add:
        ids = [add(t) for t in ["the cat sat", "a dog ran", "red mat", "blue dog"]]
    first = kb.retrieve("the cat sat", 2)
    assert first[0]["doc"]["id"] == ids[0], first
    kb.close()
    kb = KB(path, device="cpu")  # rebuilt from the stored params
    assert kb.retrieve("the cat sat", 2) == first
    kb.close()
    with StubServer(embed_dim=8) as srv:
        os.environ["OPENAI_BASE_URL"] = srv.url + "/v1/embeddings"
        o = asyncio.run(make_openai_embeddings_func(api_key="k")(["x", "y"]))
        l = asyncio.run(make_ollama_embeddings_func("m", base_url=srv.url)(["x"]))
        assert len(o) == 2 and len(o[0]) == 8 and l[0] == o[0]
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED + ("svs_tpu",))
    assert not loaded, loaded
    print("ROUND_TRIP_OK")
    """
)


_BLOCKED_XLMR = textwrap.dedent(
    """
    import asyncio, os, sys

    BLOCKED = ("jax", "jaxlib", "networkx", "ml_dtypes", "aiohttp", "dotenv", "svs_tpu",
               "transformers", "flax", "msgpack", "tokenizers", "sentencepiece", "regex",
               "safetensors")

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked in this test")
            return None

    sys.meta_path.insert(0, Blocker())

    import numpy as np
    from svs_tpu_torch import KB, make_local_embeddings_func
    from svs_tpu_torch.embeddings import (bpe, distilbert, encoders, graphemes, precompiled,
                                          tokenizer_json, unigram)

    path = sys.argv[1]
    ck = os.path.join(os.path.dirname(path), "xlmr")
    f = make_local_embeddings_func(ck, max_length=16, compute_dtype="float32", pooling="cls",
                                   device="cpu")
    texts = ["the cat sat", "héllo мир", "ﬁ <mask> 中文", "a dog ran"]
    vecs = np.asarray(asyncio.run(f(texts)))
    assert vecs.shape == (4, 32) and np.allclose(np.linalg.norm(vecs, axis=1), 1, atol=1e-5)
    tok = f.encoder._load()[0]
    assert isinstance(tok, tokenizer_json.JsonTokenizer), tok
    assert isinstance(tok.model, unigram.UnigramModel), tok.model
    kb = KB(path, f, force_fresh_db=True, device="cpu")
    with kb.bulk_add_docs() as add:
        ids = [add(t) for t in texts]
    first = kb.retrieve("héllo мир", 2)
    assert first[0]["doc"]["id"] == ids[1], first
    kb.close()
    kb = KB(path, device="cpu")  # rebuilt from the stored params
    assert kb.retrieve("héllo мир", 2) == first
    kb.close()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("ROUND_TRIP_OK")
    """
)


_BLOCKED_FAMILIES = textwrap.dedent(
    """
    import asyncio, os, sys

    BLOCKED = ("jax", "jaxlib", "networkx", "ml_dtypes", "aiohttp", "dotenv", "svs_tpu",
               "transformers", "flax", "msgpack", "tokenizers", "sentencepiece", "regex",
               "safetensors")

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked in this test")
            return None

    sys.meta_path.insert(0, Blocker())

    import numpy as np
    from svs_tpu_torch import make_local_embeddings_func
    from svs_tpu_torch.embeddings import albert, big_bird, encoders

    root = os.path.dirname(sys.argv[1])
    texts = ["the cat sat", "héllo мир", "a [MASK] b", "a dog ran " * 20]
    for name, max_length, cls in (("albert", 16, albert.AlbertEncoder),
                                  ("big_bird", 64, big_bird.BigBirdEncoder)):
        f = make_local_embeddings_func(os.path.join(root, name), max_length=max_length,
                                       compute_dtype="float32", device="cpu")
        vecs = np.asarray(asyncio.run(f(texts)))
        assert vecs.shape == (4, 32) and np.allclose(np.linalg.norm(vecs, axis=1), 1, atol=1e-5)
        assert isinstance(f.encoder._load()[1], cls)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("ROUND_TRIP_OK")
    """
)

_BLOCKED_DECODERS = textwrap.dedent(
    """
    import asyncio, os, sys

    BLOCKED = ("jax", "jaxlib", "networkx", "ml_dtypes", "aiohttp", "dotenv", "svs_tpu",
               "transformers", "flax", "msgpack", "tokenizers", "sentencepiece", "regex",
               "safetensors")

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked in this test")
            return None

    sys.meta_path.insert(0, Blocker())

    import numpy as np
    from svs_tpu_torch import make_local_embeddings_func
    from svs_tpu_torch.embeddings import checkpoint, encoders, llama

    root = os.path.dirname(sys.argv[1])
    texts = ["the cat sat", "héllo мир 中文", "", "a dog ran " * 20]
    for name in ("mistral", "gemma"):
        path = os.path.join(root, name)
        assert len(checkpoint.shard_files(path)) > 1, name
        f = make_local_embeddings_func(path, max_length=16, compute_dtype="float32", device="cpu")
        vecs = np.asarray(asyncio.run(f(texts)))
        assert vecs.shape == (4, 32) and np.allclose(np.linalg.norm(vecs, axis=1), 1, atol=1e-5)
        assert isinstance(f.encoder._load()[1], llama.LlamaEncoder)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("ROUND_TRIP_OK")
    """
)

_BLOCKED_GPT_DECODERS = textwrap.dedent(
    """
    import asyncio, os, sys

    BLOCKED = ("jax", "jaxlib", "networkx", "ml_dtypes", "aiohttp", "dotenv", "svs_tpu",
               "transformers", "flax", "msgpack", "tokenizers", "sentencepiece", "regex",
               "safetensors")

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked in this test")
            return None

    sys.meta_path.insert(0, Blocker())

    import numpy as np
    from svs_tpu_torch import make_local_embeddings_func
    from svs_tpu_torch.embeddings import bloom, checkpoint, gpt2, gpt_neo, gptj, xglm

    root = os.path.dirname(sys.argv[1])
    texts = ["the cat sat", "héllo мир 中文", "x", "a dog ran " * 20]
    classes = {"gpt2": gpt2.GPT2Encoder, "gpt_neo": gpt_neo.GPTNeoEncoder,
               "gptj": gptj.GPTJEncoder, "bloom": bloom.BloomEncoder, "xglm": xglm.XGLMEncoder}
    for name, cls in classes.items():
        path = os.path.join(root, name)
        assert len(checkpoint.shard_files(path)) > 1, name
        for dtype in ("float32", "bfloat16"):
            f = make_local_embeddings_func(path, max_length=16, compute_dtype=dtype, device="cpu")
            vecs = np.asarray(asyncio.run(f(texts)))
            assert vecs.shape == (4, 32) and np.allclose(np.linalg.norm(vecs, axis=1), 1, atol=1e-5)
        assert isinstance(f.encoder._load()[1], cls)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("ROUND_TRIP_OK")
    """
)

_BLOCKED_SEQ2SEQ = textwrap.dedent(
    """
    import asyncio, os, sys

    BLOCKED = ("jax", "jaxlib", "networkx", "ml_dtypes", "aiohttp", "dotenv", "svs_tpu",
               "transformers", "flax", "msgpack", "tokenizers", "sentencepiece", "regex",
               "safetensors")

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked in this test")
            return None

    sys.meta_path.insert(0, Blocker())

    import numpy as np
    from svs_tpu_torch import make_local_embeddings_func
    from svs_tpu_torch.embeddings import bart, blenderbot, checkpoint, pegasus, seq2seq

    root = os.path.dirname(sys.argv[1])
    texts = ["the cat sat", "héllo мир 中文", "x", "a dog ran " * 20]
    classes = {"bart": bart.BartEncoder, "mbart": bart.BartEncoder,
               "pegasus": pegasus.PegasusEncoder, "blenderbot": blenderbot.BlenderbotEncoder,
               "blenderbot-small": blenderbot.BlenderbotEncoder}
    for name, cls in classes.items():
        path = os.path.join(root, name)
        assert len(checkpoint.shard_files(path)) > 1, name
        for dtype in ("float32", "bfloat16"):
            f = make_local_embeddings_func(path, max_length=16, compute_dtype=dtype, device="cpu")
            vecs = np.asarray(asyncio.run(f(texts)))
            assert vecs.shape == (4, 32) and np.allclose(np.linalg.norm(vecs, axis=1), 1, atol=1e-5)
        assert isinstance(f.encoder._load()[1], cls)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("ROUND_TRIP_OK")
    """
)

_BLOCKED_PARALLEL = textwrap.dedent(
    """
    import sys

    BLOCKED = ("jax", "jaxlib", "networkx", "ml_dtypes", "aiohttp", "dotenv", "svs_tpu")

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked in this test")
            return None

    sys.meta_path.insert(0, Blocker())

    import svs_tpu_torch.parallel
    import svs_tpu_torch.parallel.mesh
    import svs_tpu_torch.parallel.multihost as multihost
    import svs_tpu_torch.parallel.pairwise_sharded
    import svs_tpu_torch.parallel.replicas
    import svs_tpu_torch.parallel.sharded
    from svs_tpu_torch import KB, make_mock_embeddings_func
    from svs_tpu_torch.parallel import default_mesh, mesh_2d

    path = sys.argv[1]
    kb = KB(path, make_mock_embeddings_func(), force_fresh_db=True,
            mesh=default_mesh(devices=["cpu"] * 4))
    with kb.bulk_add_docs() as add:
        ids = [add(f"doc {i}") for i in range(6)]
    hits = kb.retrieve("anything", 3)
    assert [h["doc"]["id"] for h in hits] == ids[::-1][:3], hits
    assert len(kb.document_top_pairwise_scores(2)) == 2
    kb.close()
    kb = KB(path, mesh=mesh_2d(2, 2, devices=["cpu"] * 4), precision="f32")
    assert len(kb.retrieve("anything", 3)) == 3
    kb.close()
    kb = KB(path, replicas=["cpu"] * 3)
    assert [h["doc"]["id"] for h in kb.retrieve_batch(["a", "b", "c"], 2)[2]] == ids[::-1][:2]
    kb.close()
    mesh = multihost.initialize(devices=["cpu"] * 2)
    assert not mesh.spans_processes and mesh.devices.size == 2, mesh
    try:
        multihost.initialize(num_processes=2)
    except ValueError as exc:
        assert "without a coordinator" in str(exc), exc
    else:
        raise AssertionError("multihost.initialize took num_processes without a coordinator")
    import torch.distributed
    assert not torch.distributed.is_initialized()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("ROUND_TRIP_OK")
    """
)


_BLOCKED_PROBES = textwrap.dedent(
    """
    import sys

    BLOCKED = ("jax", "jaxlib", "networkx", "ml_dtypes", "aiohttp", "dotenv", "svs_tpu",
               "benchmarks")

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked in this test")
            return None

    sys.meta_path.insert(0, Blocker())

    import numpy as np
    import torch

    import svs_tpu_torch.probes as probes
    from svs_tpu_torch.probes import bf16_opt, common, int8_opt, select8, select9, select10, select11

    assert set(probes.launch_counts()) == {
        "int8_opt.extract", "bf16_opt.extract", "select11.same_step",
        "select11.deferred", "select11.floor", "select10.extract", "select9.extract",
        "select8.extract"}
    n, d = 2 * 8192, 128
    docs, rs = common.synth_int8(n, d, "cpu")
    qv = int8_opt.queries(common.unit_queries(16, d), "cpu")
    tiles = int8_opt.extract(docs, qv["q"], qv["qs"], qv["qb"], qv["qq"], rs, n - 100, "v3", 128)
    assert tiles.shape == (16, 2 * 128)
    assert int8_opt.agreement(docs, rs, qv, n - 100) > 0.99
    d16 = common.synth_bf16(n, 256, "cpu")
    q16 = torch.from_numpy(common.unit_queries(16, 256)).to(torch.bfloat16)
    assert bf16_opt.extract(d16, q16, n - 100, "v3", 128, 4096).shape == (16, 4 * 128)
    both = select11.packed4096(d16, q16, n - 100, 40, True)
    assert both.shape == (16, 2, 40) and torch.isfinite(both).all()
    assert select11.floor(d16, q16, 8192).shape == (16, 2 * 128)
    assert select9.extract(d16, q16, n - 100, "v2").shape == (16, 2 * 128)
    assert torch.isfinite(select9.full_v3(d16, q16, n - 100, 40)[2]).all()
    assert select8.extract(d16, q16, n - 100, "h6g128").shape == (16, 2 * 384)
    assert torch.equal(select8.extract(d16, q16, n - 100, "hier"),
                       select8.extract(d16, q16, n - 100, "current"))
    both = select10.packed(d16, q16[:5].float(), n - 100, 40, 3)
    assert both.shape == (5, 2, 40) and torch.isfinite(both).all()
    assert probes.launch_counts() == dict.fromkeys(probes.launch_counts(), 0)  # the CPU launches nothing
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("ROUND_TRIP_OK")
    """
)


def _run_blocked(script: str, tmp_path: Path) -> None:
    repo = Path(svs_tpu_torch.__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-c", script, str(tmp_path / "kb.sqlite")],
        cwd=repo,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "ROUND_TRIP_OK" in proc.stdout


def test_imports_and_round_trips_without_jax(tmp_path):
    _run_blocked(_BLOCKED_ROUND_TRIP, tmp_path)


def test_bf16_round_trip_and_batch_of_300_without_jax(tmp_path):
    _run_blocked(_BLOCKED_BF16_WIDE_BATCH, tmp_path)


def test_pairwise_without_jax(tmp_path):
    _run_blocked(_BLOCKED_PAIRWISE, tmp_path)


def test_filters_and_async_kb_without_jax(tmp_path):
    _run_blocked(_BLOCKED_FILTERS_ASYNC, tmp_path)


def test_host_route_and_deferred_upload_without_jax(tmp_path):
    _run_blocked(_BLOCKED_HOST_ROUTE, tmp_path)


def test_serve_cli_tools_util_without_jax_or_aiohttp(tmp_path):
    """``serve`` (answering a request over ``http.client``), ``cli``
    (``python -m svs_tpu_torch --help``, ``info``), ``tools``, ``util``,
    ``__main__`` and ``load_env`` with ``svs_tpu``, JAX, ``aiohttp``,
    ``dotenv`` and ``networkx`` blocked."""
    _run_blocked(_BLOCKED_SERVE_CLI_TOOLS, tmp_path)


def test_providers_calibration_trace_without_jax_transformers_flax_msgpack_aiohttp(tmp_path):
    """The local provider embeds on the CPU (a checkpoint written by the
    port's own writer), a store written with it reopens with no function,
    and the openai / ollama providers answer from a stdlib stub, with JAX,
    ``svs_tpu``, ``transformers``, ``flax``, ``msgpack`` and ``aiohttp``
    blocked; the calibration and trace modules import."""
    _run_blocked(_BLOCKED_PROVIDERS, tmp_path)


def test_xlmr_provider_without_transformers_tokenizers_sentencepiece_regex(tmp_path):
    """The local provider on an XLM-R checkpoint (a Unigram ``tokenizer.json``
    with XLM-R's ``Precompiled`` normalizer, weights written by the smoke's
    writer) embeds on the CPU, and a store written with it reopens with no
    function, with ``transformers``, ``tokenizers``, ``sentencepiece``,
    ``regex``, ``flax``, JAX and ``svs_tpu`` blocked."""
    pytest.importorskip("tokenizers")
    pytest.importorskip("transformers")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import chip_smoke
    from torch_tokenizer_helpers import write_unigram_tokenizer

    ck = tmp_path / "xlmr"
    vocab = write_unigram_tokenizer(ck, seed=9)
    chip_smoke.write_random_encoder(ck, {
        "model_type": "xlm-roberta", "vocab_size": vocab, "hidden_size": 32,
        "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 64,
        "max_position_embeddings": 64, "type_vocab_size": 1, "hidden_act": "gelu",
        "layer_norm_eps": 1e-5, "pad_token_id": 1}, seed=3)
    _run_blocked(_BLOCKED_XLMR, tmp_path)


def test_albert_and_big_bird_without_transformers_tokenizers_sentencepiece(tmp_path):
    """The ALBERT and block-sparse BigBird encoders (SentencePiece
    ``tokenizer.json`` files, weights written by the smoke's writer) embed
    on the CPU with ``transformers``, ``tokenizers``, ``sentencepiece``,
    ``regex``, ``flax``, JAX and ``svs_tpu`` blocked."""
    pytest.importorskip("tokenizers")
    pytest.importorskip("transformers")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import chip_smoke
    from torch_tokenizer_helpers import write_sentencepiece_tokenizer

    tiny = {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
            "intermediate_size": 64, "type_vocab_size": 2, "layer_norm_eps": 1e-12}
    vocab = write_sentencepiece_tokenizer(tmp_path / "albert", "albert", seed=2)
    chip_smoke.write_random_encoder(tmp_path / "albert", {
        **tiny, "model_type": "albert", "vocab_size": vocab, "embedding_size": 16,
        "max_position_embeddings": 64, "hidden_act": "gelu_new", "num_hidden_groups": 1,
        "inner_group_num": 1}, seed=3)
    vocab = write_sentencepiece_tokenizer(tmp_path / "big_bird", "big_bird", seed=2)
    chip_smoke.write_random_encoder(tmp_path / "big_bird", {
        **tiny, "model_type": "big_bird", "vocab_size": vocab, "max_position_embeddings": 128,
        "hidden_act": "gelu_new", "attention_type": "block_sparse", "block_size": 16,
        "num_random_blocks": 3}, seed=3)
    _run_blocked(_BLOCKED_FAMILIES, tmp_path)

def test_llama_family_decoders_without_transformers_tokenizers_flax(tmp_path):
    """The Mistral and Gemma decoders (sharded bf16 checkpoints that the
    smoke's writer makes from a seed, tokenizers in Llama-2's and Gemma's
    layouts) embed on the CPU with ``transformers``, ``tokenizers``,
    ``flax``, JAX and ``svs_tpu`` blocked."""
    pytest.importorskip("transformers")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import chip_smoke
    from svs_tpu_torch.embeddings.checkpoint import write_checkpoint

    tiny = {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
            "intermediate_size": 64, "max_position_embeddings": 64}
    for name, cfg in (("mistral", {**tiny, "model_type": "mistral", "num_key_value_heads": 2,
                                   "sliding_window": 4}),
                      ("gemma", {**tiny, "model_type": "gemma", "num_key_value_heads": 1,
                                 "head_dim": 8})):
        layout = "gemma" if name == "gemma" else "llama"
        pad = {} if name == "gemma" else {"pad_token": "</s>"}
        chip_smoke.write_decoder_tokenizer(tmp_path / name, layout, 600, 3, **pad)
        cfg["vocab_size"] = 600
        write_checkpoint(tmp_path / name, cfg, chip_smoke.random_decoder_params(cfg, 3, "cpu"),
                         max_shard_size=20_000)
    _run_blocked(_BLOCKED_DECODERS, tmp_path)


def test_gpt_bloom_xglm_decoders_without_transformers_tokenizers_flax(tmp_path):
    """The GPT-2, GPT-Neo, GPT-J, BLOOM and XGLM decoders (sharded bf16
    checkpoints that the smoke's writer makes from a seed, GPT-J's and
    BLOOM's as ``*ForCausalLM`` trees; byte-level BPE and XGLM Unigram
    tokenizers) embed on the CPU in f32 and bf16 with ``transformers``,
    ``tokenizers``, ``flax``, JAX and ``svs_tpu`` blocked."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import chip_smoke
    from svs_tpu_torch.embeddings.checkpoint import write_checkpoint

    configs = {
        "gpt2": {"n_embd": 32, "n_layer": 2, "n_head": 4, "n_positions": 64},
        "gpt_neo": {"hidden_size": 32, "num_layers": 2, "num_heads": 4, "window_size": 4,
                    "attention_types": [[["global", "local"], 1]], "max_position_embeddings": 64},
        "gptj": {"n_embd": 32, "n_layer": 2, "n_head": 2, "rotary_dim": 8, "n_positions": 64},
        "bloom": {"hidden_size": 32, "n_layer": 2, "n_head": 4},
        "xglm": {"d_model": 32, "num_layers": 2, "attention_heads": 4, "ffn_dim": 64,
                 "max_position_embeddings": 64},
    }
    for name, keys in configs.items():
        size = 5000 if name == "xglm" else 600
        cfg = {"model_type": name, "vocab_size": size, **keys}
        chip_smoke.write_decoder_tokenizer_of(tmp_path / name, name, size, 3)
        tree = chip_smoke.random_decoder_params(cfg, 3, "cpu")
        if name in ("gptj", "bloom"):
            tree = chip_smoke.with_head(cfg, tree, 4)
        write_checkpoint(tmp_path / name, cfg, tree, max_shard_size=20_000)
    _run_blocked(_BLOCKED_GPT_DECODERS, tmp_path)


def test_seq2seq_types_without_transformers_tokenizers_flax(tmp_path):
    """The BART, mBART, Pegasus, Blenderbot and Blenderbot-small stacks
    (sharded bf16 checkpoints that the smoke's writer makes from a seed,
    mBART's, Pegasus's and Blenderbot's as ``*ForConditionalGeneration``
    trees; the byte-level BPE of BART and the Blenderbots, the Unigram of
    mBART-50 and Pegasus) embed on the CPU in f32 and bf16 with
    ``transformers``, ``tokenizers``, ``flax``, JAX and ``svs_tpu``
    blocked."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import chip_smoke
    from svs_tpu_torch.embeddings.checkpoint import write_checkpoint

    tiny = {"d_model": 32, "encoder_layers": 2, "decoder_layers": 2,
            "encoder_attention_heads": 4, "decoder_attention_heads": 4,
            "encoder_ffn_dim": 48, "decoder_ffn_dim": 48, "max_position_embeddings": 64}
    for name in ("bart", "mbart", "pegasus", "blenderbot", "blenderbot-small"):
        size = 3000 if name in ("mbart", "pegasus") else 600
        cfg = {"model_type": name, "vocab_size": size, "scale_embedding": name != "bart", **tiny}
        chip_smoke.write_decoder_tokenizer_of(tmp_path / name, name, size, 3)
        tree = chip_smoke.random_seq2seq_params(cfg, 3, "cpu")
        if name in ("mbart", "pegasus", "blenderbot"):
            tree = chip_smoke.with_head(cfg, tree, 4)
        write_checkpoint(tmp_path / name, cfg, tree, max_shard_size=20_000)
    _run_blocked(_BLOCKED_SEQ2SEQ, tmp_path)


def test_parallel_modules_without_jax_or_svs_tpu(tmp_path):
    """Every module of ``svs_tpu_torch.parallel`` imports with JAX and
    ``svs_tpu`` blocked; a mesh KB (1-D and 2-D) and a replica KB answer
    on repeated CPU devices; ``multihost.initialize`` without a
    coordinator returns the one-process mesh and refuses a process count
    without one."""
    _run_blocked(_BLOCKED_PARALLEL, tmp_path)


def test_kb_without_device_refuses_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: KB() legitimately uses it")
    with pytest.raises(RuntimeError, match="CUDA"):
        svs_tpu_torch.KB(
            tmp_path / "kb.sqlite",
            svs_tpu_torch.make_mock_embeddings_func(),
            force_fresh_db=True,
        )
    assert not (tmp_path / "kb.sqlite").exists()


def test_probes_without_jax_svs_tpu_or_benchmarks(tmp_path):
    """Every module of ``svs_tpu_torch.probes`` imports with JAX,
    ``svs_tpu`` and ``benchmarks`` blocked, and their plain versions run on
    CPU tensors (no kernel launch counted)."""
    _run_blocked(_BLOCKED_PROBES, tmp_path)


def test_probe_entry_points_without_device_refuse_cpu():
    """A probe's main and its data makers, with no card and no
    ``device="cpu"``, raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the probes legitimately use it")
    from svs_tpu_torch.probes import bf16_opt, common, int8_opt, select8, select9, select10, select11

    for main in (int8_opt.main, bf16_opt.main, select11.main, select10.main, select9.main,
                 select8.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        common.synth_int8(8192, 128)
