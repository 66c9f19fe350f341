"""Helpers for the port's embedding-provider tests: a standard-library
loopback HTTP server that records POSTs and answers from a script (or as
an OpenAI / Ollama embeddings endpoint with seeded unit vectors), and a
tiny BERT checkpoint written from a seed with the port's own writer (no
``transformers`` or ``flax``)."""

import json
import threading
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

TINY_VOCAB = (
    "[PAD] [UNK] [CLS] [SEP] [MASK] the a cat dog sat mat on ran red "
    "blue fast slow happy sad big small jumps sleeps eats barks meows"
).split()


def seeded_unit(text, dim):
    rng = np.random.default_rng(zlib.crc32(text.encode()))
    v = rng.standard_normal(dim)
    return (v / np.linalg.norm(v)).tolist()


class StubServer:
    """Loopback POST recorder.  ``responses`` is a queue of ``(status,
    json body)`` whose last entry repeats (a body ``{"__raw__": text}`` is
    sent as it is); with ``embed_dim`` set and nothing queued, it answers
    ``/v1/embeddings`` (OpenAI) and ``/api/embed`` (Ollama) with seeded
    unit vectors of that width."""

    def __init__(self, embed_dim=None):
        self.requests = []  # (path, headers dict, raw body bytes)
        self.client_ports = []  # the client's port of each request
        self.responses = []
        self.embed_dim = embed_dim
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def do_POST(self):
                raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                stub.requests.append((self.path, dict(self.headers), raw))
                stub.client_ports.append(self.client_address[1])
                status, payload = stub._answer(self.path, raw)
                body = (payload["__raw__"] if isinstance(payload, dict) and "__raw__" in payload
                        else json.dumps(payload)).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def _answer(self, path, raw):
        if self.responses:
            return self.responses.pop(0) if len(self.responses) > 1 else self.responses[0]
        texts = json.loads(raw)["input"]
        vecs = [seeded_unit(t, self.embed_dim) for t in texts]
        if path.endswith("/api/embed"):
            return 200, {"embeddings": vecs}
        return 200, {"data": [{"index": i, "embedding": v} for i, v in enumerate(vecs)]}

    @property
    def url(self):
        return f"http://127.0.0.1:{self.port}"

    def close(self):
        self._server.shutdown()
        self._server.server_close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def tiny_bert_params(config, seed):
    """A Flax BertModel parameter tree of the config's widths, N(0, 0.02)
    weights and unit LayerNorms, from a seed."""
    rng = np.random.default_rng(seed)
    h, inter = config["hidden_size"], config["intermediate_size"]

    def dense(d_in, d_out):
        return {"kernel": rng.normal(0, 0.02, (d_in, d_out)).astype(np.float32),
                "bias": rng.normal(0, 0.02, (d_out,)).astype(np.float32)}

    def norm():
        return {"scale": np.ones(h, np.float32), "bias": np.zeros(h, np.float32)}

    def embed(n):
        return {"embedding": rng.normal(0, 0.02, (n, h)).astype(np.float32)}

    layers = {}
    for i in range(config["num_hidden_layers"]):
        layers[str(i)] = {
            "attention": {
                "self": {"query": dense(h, h), "key": dense(h, h), "value": dense(h, h)},
                "output": {"dense": dense(h, h), "LayerNorm": norm()},
            },
            "intermediate": {"dense": dense(h, inter)},
            "output": {"dense": dense(inter, h), "LayerNorm": norm()},
        }
    return {
        "embeddings": {
            "word_embeddings": embed(config["vocab_size"]),
            "position_embeddings": embed(config["max_position_embeddings"]),
            "token_type_embeddings": embed(config["type_vocab_size"]),
            "LayerNorm": norm(),
        },
        "encoder": {"layer": layers},
        "pooler": {"dense": dense(h, h)},
    }


def write_tiny_bert(path, seed=7, model_type="bert", vocab=TINY_VOCAB):
    """A 2-layer, 32-wide BERT checkpoint directory (config.json,
    flax_model.msgpack, vocab.txt, tokenizer_config.json) written with the
    port's own MessagePack writer."""
    from svs_tpu_torch.embeddings.checkpoint import write_checkpoint

    path = Path(path)
    config = {
        "model_type": model_type, "vocab_size": len(vocab), "hidden_size": 32,
        "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 64,
        "max_position_embeddings": 64, "type_vocab_size": 2, "hidden_act": "gelu",
        "layer_norm_eps": 1e-12, "position_embedding_type": "absolute",
    }
    write_checkpoint(path, config, tiny_bert_params(config, seed))
    (path / "vocab.txt").write_text("\n".join(vocab) + "\n", encoding="utf-8")
    (path / "tokenizer_config.json").write_text(
        json.dumps({"do_lower_case": True, "tokenizer_class": "BertTokenizer"})
    )
    return path
