"""The port's HTTP embedding providers (``svs_tpu_torch.embeddings.http``,
``openai``, ``ollama``: a standard-library transport) against a loopback
stub server: the nine cases of the reference's
``tests/test_providers_http.py`` (golden request bodies, bounded retry on
5xx/429, terminal 4xx, exhausted retries, transport errors, a 200 with a
non-JSON body, the untrusted ollama ``base_url``), and the request bodies
byte-equal to ``svs_tpu``'s (``aiohttp``) on the same stub.  No test
asserts on wall-clock time."""

import asyncio
import json
import logging

import pytest

import svs_tpu_torch.embeddings as port_embeddings
from svs_tpu_torch.embeddings import (
    make_embeddings_func,
    make_ollama_embeddings_func,
    make_openai_embeddings_func,
)
from svs_tpu_torch.embeddings import http as port_http
from svs_tpu_torch.embeddings.http import ProviderHTTPError, post_json

from torch_provider_helpers import StubServer


@pytest.fixture
def srv():
    with StubServer() as s:
        yield s


@pytest.fixture
def no_jitter(monkeypatch):
    # kill the jitter so the real backoffs stay ~0.5 s + 1 s
    monkeypatch.setattr(port_http.random, "random", lambda: 0.0)


def _openai_ok(vectors):
    return {"data": [{"index": i, "embedding": [float(x) for x in v]}
                     for i, v in enumerate(vectors)]}


def _body(request):
    return json.loads(request[2])


def test_openai_request_body_golden(srv, monkeypatch):
    srv.responses = [(200, _openai_ok([[1.0, 0.0], [0.0, 1.0]]))]
    monkeypatch.setenv("OPENAI_BASE_URL", f"{srv.url}/v1/embeddings")
    fn = make_openai_embeddings_func(
        model="text-embedding-3-small", api_key="sk-test", dimensions=2
    )
    assert asyncio.run(fn(["alpha", "beta"])) == [[1.0, 0.0], [0.0, 1.0]]
    path, headers, _ = srv.requests[0]
    assert path == "/v1/embeddings"
    assert headers["Authorization"] == "Bearer sk-test"
    assert headers["Content-Type"] == "application/json"
    assert _body(srv.requests[0]) == {
        "input": ["alpha", "beta"],
        "model": "text-embedding-3-small",
        "encoding_format": "float",
        "dimensions": 2,
    }


def test_ollama_request_body_golden(srv):
    srv.responses = [(200, {"embeddings": [[0.5, 0.5]]})]
    fn = make_ollama_embeddings_func(model="mxbai", base_url=srv.url)
    assert asyncio.run(fn(["hello"])) == [[0.5, 0.5]]
    assert srv.requests[0][0] == "/api/embed"
    assert _body(srv.requests[0]) == {
        "model": "mxbai", "truncate": True, "keep_alive": "5m", "input": ["hello"],
    }


def test_retry_on_5xx_then_success(srv, no_jitter):
    srv.responses = [
        (503, {"error": "overloaded"}),
        (429, {"error": "slow down"}),
        (200, {"ok": True}),
    ]
    data = asyncio.run(post_json("test", f"{srv.url}/x", {"a": 1}, timeout_s=5, retries=3))
    assert data == {"ok": True}
    assert len(srv.requests) == 3


def test_no_retry_on_terminal_4xx(srv):
    srv.responses = [(401, {"error": {"message": "bad key"}})]
    with pytest.raises(ProviderHTTPError) as exc:
        asyncio.run(post_json("openai", f"{srv.url}/x", {}, timeout_s=5, retries=3))
    assert exc.value.status == 401
    assert str(exc.value) == "openai embeddings request failed (HTTP 401): bad key"
    assert len(srv.requests) == 1  # no retries burned on a caller bug


def test_retries_exhausted_raises(srv, no_jitter):
    srv.responses = [(503, {"error": "down"})]
    with pytest.raises(ProviderHTTPError) as exc:
        asyncio.run(post_json("ollama", f"{srv.url}/x", {}, timeout_s=5, retries=1))
    assert exc.value.status is None
    assert str(exc.value) == (
        "ollama embeddings request failed: retries exhausted; last: HTTP 503: down"
    )
    assert len(srv.requests) == 2  # initial + 1 retry


def test_timeout_then_failure():
    # a port nobody listens on: a transport error, no retries
    with pytest.raises(ProviderHTTPError, match="retries exhausted"):
        asyncio.run(post_json("test", "http://127.0.0.1:9/none", {}, timeout_s=0.5, retries=0))


def test_200_with_non_json_body_is_retried_then_raises(srv, no_jitter):
    srv.responses = [(200, {"__raw__": "<html>splash</html>"})]
    with pytest.raises(ProviderHTTPError, match="non-JSON"):
        asyncio.run(post_json("test", srv.url + "/x", {}, retries=1, timeout_s=5))
    assert len(srv.requests) == 2


def test_200_non_json_then_good_json_succeeds(srv, no_jitter):
    srv.responses = [(200, {"__raw__": "garbage"}), (200, {"ok": 1})]
    assert asyncio.run(post_json("test", srv.url + "/x", {}, retries=2, timeout_s=5)) == {"ok": 1}


def test_untrusted_params_drop_ollama_base_url(caplog):
    params = {
        "provider": "ollama", "model": "m", "truncate": True,
        "keep_alive": "5m", "base_url": "https://attacker.example",
    }
    with caplog.at_level(logging.WARNING):
        fn = make_embeddings_func(params, trusted=False)
    assert any("attacker.example" in r.message for r in caplog.records)
    assert fn.__embedding_func_params__["base_url"] is None
    fn2 = make_embeddings_func(params, trusted=True)
    assert fn2.__embedding_func_params__["base_url"] == "https://attacker.example"


def test_one_connection_per_call_reused_across_retries(srv, no_jitter):
    """The retries of one call ride one keep-alive connection."""
    srv.responses = [(503, {"error": "x"}), (503, {"error": "x"}), (200, {"ok": True})]
    asyncio.run(post_json("test", f"{srv.url}/x", {}, timeout_s=5, retries=3))
    assert len(srv.requests) == 3 and len(set(srv.client_ports)) == 1


def test_single_flight_lru_shares_one_request(srv, monkeypatch):
    """Concurrent identical calls share one POST (the async LRU)."""
    monkeypatch.setenv("OPENAI_BASE_URL", f"{srv.url}/v1/embeddings")
    srv.responses = [(200, _openai_ok([[0.6, 0.8]]))]
    fn = make_openai_embeddings_func(api_key="sk-lru", model="lru-model")

    async def run():
        return await asyncio.gather(*(fn(["same text"]) for _ in range(5)))

    assert asyncio.run(run()) == [[[0.6, 0.8]]] * 5
    assert len(srv.requests) == 1


@pytest.mark.parametrize("provider", ["openai", "ollama"])
def test_request_bodies_equal_svs_tpu(srv, monkeypatch, provider):
    """The bytes each package posts for the same call on the same stub."""
    pytest.importorskip("aiohttp")  # the reference's transport
    import svs_tpu.embeddings as ref

    srv.embed_dim = 4
    monkeypatch.setenv("OPENAI_BASE_URL", f"{srv.url}/v1/embeddings")
    texts = ["alpha", "β unicode é", 'quote " and \\ backslash']
    got = {}
    for name, pkg in (("ref", ref), ("port", port_embeddings)):
        if provider == "openai":
            fn = pkg.make_openai_embeddings_func(api_key="sk-x", dimensions=4, user="u1")
        else:
            fn = pkg.make_ollama_embeddings_func(model="mxbai", base_url=srv.url)
        before = len(srv.requests)
        out = asyncio.run(fn(list(texts)))
        got[name] = (out, srv.requests[before:])
    (ref_out, ref_req), (port_out, port_req) = got["ref"], got["port"]
    assert port_out == ref_out
    assert len(ref_req) == len(port_req) == 1
    assert port_req[0][0] == ref_req[0][0]
    assert port_req[0][2] == ref_req[0][2]  # the body, byte for byte
    for h in ("Content-Type", "Authorization"):
        assert port_req[0][1].get(h) == ref_req[0][1].get(h)
