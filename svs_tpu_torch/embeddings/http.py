"""Shared HTTP machinery for the embedding providers (port of
``svs_tpu.embeddings.http`` on the standard library).

``svs_tpu`` posts through ``aiohttp``; the machine with the card has no
``aiohttp``, so this transport is ``http.client`` (``ssl`` for https) run
in the event loop's default executor, with ONE connection per call,
reused across its retries (keep-alive; reconnected after a transport
error).  Everything a caller sees is the reference's:

- a request timeout (``SVS_TPU_HTTP_TIMEOUT`` seconds, default 120; here
  the socket timeout of the connect and of each read);
- bounded retries with exponential backoff + jitter on transport errors
  and on retryable statuses (429 and 5xx), never on other 4xx, which are
  caller bugs (``SVS_TPU_HTTP_RETRIES``, default 3);
- a 200 whose body is not JSON is retried, never returned as ``None``;
- the request body is ``json.dumps(payload)`` in UTF-8, the bytes
  ``aiohttp``'s ``json=`` sends, with ``Content-Type: application/json``;
- one place that shapes provider errors (:class:`ProviderHTTPError`).
"""

from __future__ import annotations

import asyncio
import http.client
import json
import logging
import os
import random
import ssl
from typing import Any, Dict, Optional, Tuple
from urllib.parse import urlsplit

log = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = float(os.environ.get("SVS_TPU_HTTP_TIMEOUT", "120"))
DEFAULT_RETRIES = int(os.environ.get("SVS_TPU_HTTP_RETRIES", "3"))
_RETRYABLE_STATUSES = frozenset({429, 500, 502, 503, 504})


class ProviderHTTPError(RuntimeError):
    """An embeddings backend rejected the request (terminally)."""

    def __init__(
        self, provider: str, status: Optional[int], detail: str
    ) -> None:
        self.provider = provider
        self.status = status
        super().__init__(
            f"{provider} embeddings request failed"
            + (f" (HTTP {status})" if status is not None else "")
            + f": {detail}"
        )


class _Connection:
    """One keep-alive ``http.client`` connection to ``url``'s host; every
    method blocks (callers run it in an executor)."""

    def __init__(self, url: str, timeout_s: float) -> None:
        parts = urlsplit(url)
        if parts.scheme not in ("http", "https") or not parts.hostname:
            raise ValueError(f"not an http(s) URL: {url!r}")
        self.target = parts.path or "/"
        if parts.query:
            self.target += "?" + parts.query
        if parts.scheme == "https":
            self.conn: http.client.HTTPConnection = http.client.HTTPSConnection(
                parts.hostname, parts.port, timeout=timeout_s,
                context=ssl.create_default_context(),
            )
        else:
            self.conn = http.client.HTTPConnection(
                parts.hostname, parts.port, timeout=timeout_s
            )

    def post(self, body: bytes, headers: Dict[str, str]) -> Tuple[int, bytes]:
        try:
            self.conn.request("POST", self.target, body=body, headers=headers)
            response = self.conn.getresponse()
            return response.status, response.read()
        except BaseException:
            self.conn.close()  # the next attempt reconnects
            raise

    def close(self) -> None:
        self.conn.close()


def _decode(raw: bytes) -> Any:
    """The body as JSON, ``None`` when it is empty or not JSON (as
    ``aiohttp``'s ``response.json(content_type=None)`` is read there)."""
    text = raw.strip()
    if not text:
        return None
    try:
        return json.loads(text.decode("utf-8"))
    except ValueError:
        return None


async def post_json(
    provider: str,
    url: str,
    payload: Dict[str, Any],
    headers: Optional[Dict[str, str]] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    retries: int = DEFAULT_RETRIES,
) -> Any:
    """POST ``payload`` as JSON; return the decoded JSON response body.

    Raises :class:`ProviderHTTPError` after exhausting ``retries`` attempts
    (transport errors / retryable statuses) or immediately on a
    non-retryable error status.
    """
    loop = asyncio.get_running_loop()
    body = json.dumps(payload).encode("utf-8")
    all_headers = {"Content-Type": "application/json", "Accept": "*/*"}
    all_headers.update(headers or {})
    last_detail = "no attempts made"
    conn = _Connection(url, timeout_s)
    try:
        for attempt in range(retries + 1):
            if attempt:
                delay = min(30.0, 0.5 * 2 ** (attempt - 1)) * (
                    1 + random.random()
                )
                log.warning(
                    "%s request retry %d/%d in %.1fs (%s)",
                    provider, attempt, retries, delay, last_detail,
                )
                await asyncio.sleep(delay)
            try:
                status, raw = await loop.run_in_executor(
                    None, conn.post, body, all_headers
                )
            except (OSError, http.client.HTTPException) as exc:
                last_detail = f"{type(exc).__name__}: {exc}"
                continue
            data = _decode(raw)
            if status == 200:
                if data is None:
                    # 200 with an unparseable/empty body (proxy splash
                    # page, truncated response): retryable, never a None
                    # return that crashes the provider with a TypeError
                    last_detail = "HTTP 200 with non-JSON body"
                    continue
                return data
            detail = _error_detail(data)
            if status not in _RETRYABLE_STATUSES:
                raise ProviderHTTPError(provider, status, detail)
            last_detail = f"HTTP {status}: {detail}"
    finally:
        conn.close()
    raise ProviderHTTPError(provider, None, f"retries exhausted; last: {last_detail}")


def _error_detail(data: Any) -> str:
    """Best-effort human detail from a JSON error body."""
    if isinstance(data, dict):
        err = data.get("error")
        if isinstance(err, dict) and "message" in err:
            return str(err["message"])
        if isinstance(err, str):
            return err
        return str(data)
    return repr(data)
