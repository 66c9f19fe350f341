"""File, URL, and gzip plumbing for portable single-file knowledge bases.

A KB can be opened from a local path, a ``file://`` path, a ``.gz``
compressed file, or an ``http(s)://`` URL (downloaded once into a
content-addressed local cache).  All writes are atomic: data lands in a
``.tmp`` sibling and is ``os.replace``d into place, so a crashed download or
gzip never leaves a partial artifact behind.

Behavior parity with the reference: ``svs/util.py:96-187`` (download cache,
gzip resolution with mtime freshness) and ``svs/util.py:243-256``
(race-free delete).  aiohttp is an optional dependency here — it is only
imported when an actual ``http(s)`` URL is opened.
"""

from __future__ import annotations

import asyncio
import errno
import gzip
import hashlib
import logging
import os
import shutil
import threading
from pathlib import Path
from typing import Tuple, Union

from .aio import locked

log = logging.getLogger(__name__)

#: Where downloaded KBs are cached, keyed by sha256(url).
REMOTE_CACHE_DIR = Path(".remote_cache")

_DOWNLOAD_CHUNK_BYTES = 4096 * 4096


def delete_file_if_exists(path: Union[str, Path]) -> None:
    """Delete ``path`` if present; missing file is not an error.  Uses
    EAFP (try/except) rather than exists()+remove() to avoid the race."""
    try:
        os.remove(path)
    except OSError as exc:
        if exc.errno != errno.ENOENT:
            raise


@locked()
async def file_cached_wget(url: str) -> Path:
    """Download ``url`` into the local content-addressed cache (once) and
    return the cached path.

    The whole function is single-flight (one download at a time), which is a
    blunt but safe answer to two tasks racing on the same URL.  A failed
    download leaves no cache entry because data streams into a ``.tmp`` file
    that is only renamed into place on success.
    """
    loop = asyncio.get_running_loop()

    digest = hashlib.sha256(url.encode()).hexdigest()
    from urllib.parse import urlparse

    ext = os.path.splitext(urlparse(url).path)[1]
    dest = REMOTE_CACHE_DIR / f"{digest}{ext}"
    tmp = dest.with_suffix(dest.suffix + ".tmp")

    def check() -> bool:
        os.makedirs(dest.parent, exist_ok=True)
        return dest.exists()

    if await loop.run_in_executor(None, check):
        log.info("file_cached_wget(%r): cache hit", url)
        return dest

    log.info("file_cached_wget(%r): downloading", url)
    import aiohttp  # deferred: optional dependency

    with open(tmp, "wb") as f:
        async with aiohttp.ClientSession(raise_for_status=True) as session:
            async with session.get(url) as response:
                async for data in response.content.iter_chunked(_DOWNLOAD_CHUNK_BYTES):
                    await loop.run_in_executor(None, f.write, data)
    os.replace(tmp, dest)
    log.info("file_cached_wget(%r): done", url)
    return dest


def _split_remote_or_local(path_or_url: Union[str, Path]) -> Tuple[bool, str]:
    from urllib.parse import urlparse

    s = str(path_or_url)
    if urlparse(s).scheme in ("http", "https"):
        return True, s
    if s.startswith("file://"):
        s = s[len("file://") :]
    return False, s


async def resolve_to_local_uncompressed_file(path_or_url: Union[str, Path]) -> Path:
    """Turn any supported KB locator into a local, uncompressed file path.

    http(s) URLs are downloaded via :func:`file_cached_wget`; ``.gz`` files
    are gunzipped next to themselves, with an mtime freshness check so a
    newer ``.gz`` re-extracts but an already-fresh extraction is reused.
    """
    loop = asyncio.get_running_loop()
    is_remote, located = await loop.run_in_executor(
        None, _split_remote_or_local, path_or_url
    )
    local_path = await file_cached_wget(located) if is_remote else Path(located)

    stem, ext = os.path.splitext(local_path)
    if ext != ".gz":
        return local_path

    target = Path(stem)
    # UNIQUE tmp per extraction: concurrent opens of the same .gz (other
    # tasks, other loop threads, other PROCESSES) each write their own
    # tmp and atomically replace — last one wins with a complete file,
    # never an interleaved one.  A shared tmp path measured corruption
    # under exactly that race.
    tmp = target.with_suffix(
        target.suffix + f".{os.getpid()}.{threading.get_ident()}.tmp"
    )

    def gunzip() -> None:
        if target.exists() and os.path.getmtime(target) >= os.path.getmtime(local_path):
            log.info("resolve(%r): extracted file is fresh", str(path_or_url))
            return
        log.info("resolve(%r): gunzipping", str(path_or_url))
        try:
            with gzip.open(local_path, "rb") as src, open(tmp, "wb") as dst:
                shutil.copyfileobj(src, dst)
            os.replace(tmp, target)
        finally:
            if tmp.exists():  # failed mid-write: leave no orphan
                try:
                    tmp.unlink()
                except OSError:
                    pass

    await loop.run_in_executor(None, gunzip)
    return target


async def try_fetch_remote_sidecar(
    path_or_url: Union[str, Path], local_db_path: Union[str, Path]
) -> bool:
    """Best-effort fetch of the publisher's packed-matrix sidecar.

    A publisher's ``close()`` leaves ``<db>.svsx`` next to ``<db>.gz``; a
    consumer opening the KB from a URL skips the cold-start BLOB rescan
    when that sibling was uploaded too.  The sidecar URL is the DB URL
    minus any ``.gz`` plus ``.svsx``.  Any failure (404, network, local
    sidecar already present) is non-fatal: the engine rescans, and a stale
    or corrupt download is ignored by the sidecar's own fingerprint check.
    Returns True iff a sidecar file exists at the expected local path on
    return.
    """
    is_remote, located = _split_remote_or_local(path_or_url)
    if not is_remote:
        return False
    dest = Path(f"{local_db_path}.svsx")
    if dest.exists():
        return True
    base = located[: -len(".gz")] if located.endswith(".gz") else located
    url = f"{base}.svsx"
    try:
        cached = await file_cached_wget(url)
    except Exception as exc:
        log.info("no remote sidecar at %s (%s)", url, exc)
        return False
    loop = asyncio.get_running_loop()

    def place() -> None:
        tmp = Path(f"{dest}.tmp")
        shutil.copyfile(cached, tmp)
        os.replace(tmp, dest)

    await loop.run_in_executor(None, place)
    log.info("fetched remote sidecar %s -> %s", url, dest)
    return True


def atomic_gzip_file(src: Union[str, Path], dest: Union[str, Path]) -> None:
    """Gzip ``src`` to ``dest`` atomically (write ``dest + '.tmp'``, then
    rename).  Used by ``close(also_gzip=True)`` to publish a KB."""
    tmp = f"{dest}.tmp"
    with open(src, "rb") as f_in, gzip.open(tmp, "wb") as f_out:
        shutil.copyfileobj(f_in, f_out)
    os.replace(tmp, dest)
