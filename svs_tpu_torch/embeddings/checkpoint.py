"""Reading (and writing) a Hugging Face Flax BERT checkpoint with no
``transformers``, ``flax`` or ``msgpack``: the files ``svs_tpu``'s local
provider loads through ``FlaxAutoModel.from_pretrained``.

- :func:`resolve_model_dir` — a local directory, or a hub name that is
  already in the local Hugging Face cache (``$HF_HUB_CACHE``, else
  ``$HF_HOME/hub``, else ``~/.cache/huggingface/hub``:
  ``models--org--name/snapshots/<refs/main>``).  Nothing is downloaded.
- :func:`load_checkpoint` — ``config.json`` and ``flax_model.msgpack``:
  the parameter tree as NumPy arrays.
- :func:`unpackb` / :func:`packb` — the part of MessagePack that Flax's
  ``msgpack_serialize`` writes: maps, arrays, strings, binaries, numbers,
  ext type 1 = an ndarray (``(shape, dtype name, C-order bytes)``, itself
  MessagePack; bf16 leaves read as f32); an array past 2^30 bytes is
  stored as a ``{'__msgpack_chunked_array__': True, 'shape', 'chunks'}``
  dict and is joined back here.
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path
from typing import Any, Dict, List, Tuple, Union

import numpy as np

FLAX_WEIGHTS = "flax_model.msgpack"
CONFIG = "config.json"
_EXT_NDARRAY = 1
_CHUNKED = "__msgpack_chunked_array__"


# -- MessagePack ----------------------------------------------------------------


class _Reader:
    def __init__(self, buf: Union[bytes, memoryview]) -> None:
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated MessagePack data")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def obj(self, raw: bool) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.obj(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F, raw)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.unpack(">b"), self.take(n))
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            code = self.unpack(">b")
            return self.ext(code, self.take(1 << (b - 0xD4)))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self.string(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]), raw)
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.obj(raw) for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"), raw)
        raise ValueError(f"unsupported MessagePack byte 0x{b:02x}")

    def string(self, n: int, raw: bool) -> Union[str, bytes]:
        data = bytes(self.take(n))
        return data if raw else data.decode("utf-8")

    def map(self, n: int, raw: bool) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.obj(raw)
            out[key] = self.obj(raw)
        return out

    def ext(self, code: int, data: memoryview) -> Any:
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported MessagePack ext type {code}")
        shape, dtype, buffer = _Reader(data).obj(raw=True)
        name = dtype.decode() if isinstance(dtype, bytes) else dtype
        if name == "bfloat16":
            arr = _bf16_to_f32(np.frombuffer(buffer, dtype="<u2"))
        else:
            arr = np.frombuffer(buffer, dtype=np.dtype(name))
        return arr.reshape(shape)


def _bf16_to_f32(words: np.ndarray) -> np.ndarray:
    return (words.astype(np.uint32) << 16).view(np.float32)


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if tree.get(_CHUNKED) is True:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data: Union[bytes, memoryview]) -> Any:
    """Decode a Flax ``msgpack_serialize`` blob: nested dicts of NumPy
    arrays (read-only views of ``data``), chunked arrays joined."""
    reader = _Reader(data)
    out = reader.obj(raw=False)
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the MessagePack object")
    return _unchunk(out)


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out += b"\xc0"
    elif obj is True or obj is False:
        out += b"\xc3" if obj else b"\xc2"
    elif isinstance(obj, int):
        if 0 <= obj <= 0x7F or -32 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
        elif obj >= 0:
            out += b"\xcf" + struct.pack(">Q", obj)
        else:
            out += b"\xd3" + struct.pack(">q", obj)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out += (bytes([0xA0 | len(raw)]) if len(raw) < 32 else b"\xdb" + struct.pack(">I", len(raw)))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        out += b"\xc6" + struct.pack(">I", len(obj)) + bytes(obj)
    elif isinstance(obj, (list, tuple)):
        out += b"\xdd" + struct.pack(">I", len(obj))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        out += b"\xdf" + struct.pack(">I", len(obj))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    elif isinstance(obj, np.ndarray):
        chunks: List[Any] = []
        _pack_chunks(obj, chunks)
        out += b"".join(chunks)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def _pack_chunks(obj: Any, chunks: List[Any]) -> None:
    """:func:`_pack` into a list of byte chunks, an ndarray's data as a
    view of the array (no copy: a checkpoint of 2 GB is written as it is
    held)."""
    if isinstance(obj, dict):
        head = bytearray(b"\xdf" + struct.pack(">I", len(obj)))
        chunks.append(head)
        for key, value in obj.items():
            _pack(key, head)
            if isinstance(value, (dict, np.ndarray)):
                _pack_chunks(value, chunks)
                head = bytearray()
                chunks.append(head)
            else:
                _pack(value, head)
    elif isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        if arr.nbytes > 1 << 30:
            raise ValueError("arrays past 2^30 bytes are not written here")
        inner = bytearray(b"\xdd" + struct.pack(">I", 3))
        _pack([int(s) for s in arr.shape], inner)
        _pack(arr.dtype.name, inner)
        inner += b"\xc6" + struct.pack(">I", arr.nbytes)
        chunks.append(b"\xc9" + struct.pack(">I", len(inner) + arr.nbytes)
                      + struct.pack(">b", _EXT_NDARRAY) + bytes(inner))
        chunks.append(memoryview(arr.reshape(-1)).cast("B"))
    else:
        head = bytearray()
        _pack(obj, head)
        chunks.append(head)


def packb(tree: Any) -> bytes:
    """Encode nested dicts of NumPy arrays as Flax's ``msgpack_serialize``
    does (readable by ``flax.serialization.msgpack_restore``); for
    checkpoints written from a seed (tests, the smoke)."""
    chunks: List[Any] = []
    _pack_chunks(tree, chunks)
    return b"".join(chunks)


# -- checkpoints --------------------------------------------------------------


def hub_cache_dirs() -> Tuple[Path, ...]:
    """The local Hugging Face hub caches, in the order they are searched."""
    dirs = []
    if os.environ.get("HF_HUB_CACHE"):
        dirs.append(Path(os.environ["HF_HUB_CACHE"]))
    if os.environ.get("HF_HOME"):
        dirs.append(Path(os.environ["HF_HOME"]) / "hub")
    dirs.append(Path.home() / ".cache" / "huggingface" / "hub")
    return tuple(dirs)


def resolve_model_dir(model: Union[str, Path]) -> Path:
    """``model`` as a directory: itself when it is one, else the snapshot
    that ``refs/main`` names in the local Hugging Face cache.  Never
    downloads: a model found in neither raises ``FileNotFoundError``."""
    if os.path.isdir(model):
        return Path(model)
    name = str(model)
    searched = []
    for root in hub_cache_dirs():
        repo = root / ("models--" + name.replace("/", "--"))
        searched.append(str(repo))
        ref = repo / "refs" / "main"
        if ref.is_file():
            snap = repo / "snapshots" / ref.read_text().strip()
            if snap.is_dir():
                return snap
    raise FileNotFoundError(
        f"model {name!r} is not a local directory and is not in the local "
        f"Hugging Face cache (searched {searched}); svs_tpu_torch never "
        "downloads a checkpoint: pass a directory holding config.json, "
        f"{FLAX_WEIGHTS} and vocab.txt"
    )


def read_config(model_dir: Union[str, Path]) -> Dict[str, Any]:
    path = Path(model_dir) / CONFIG
    if not path.is_file():
        raise FileNotFoundError(f"no {CONFIG} in {model_dir}")
    return json.loads(path.read_text(encoding="utf-8"))


def load_checkpoint(model_dir: Union[str, Path]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(config, params)``: ``config.json`` and the Flax parameter tree of
    ``flax_model.msgpack`` (NumPy arrays).  A head model's checkpoint holds
    the base model under its family's ``base_model_prefix`` (``bert``,
    ``roberta``, ``xlm-roberta``, ``distilbert``, ``electra``, ``albert``,
    ``roberta_prelayernorm``; BigBird's is ``bert``), and that
    wrapper is unwrapped as ``FlaxAutoModel.from_pretrained`` unwraps it:
    only when the tree has no ``embeddings`` of its own."""
    config = read_config(model_dir)
    weights = Path(model_dir) / FLAX_WEIGHTS
    if not weights.is_file():
        raise FileNotFoundError(
            f"no {FLAX_WEIGHTS} in {model_dir} (svs_tpu's local provider "
            "loads Flax checkpoints, and so does the port)"
        )
    params = unpackb(weights.read_bytes())
    return config, unwrap_head(config, params)


def unwrap_head(config: Dict[str, Any], params: Dict[str, Any]) -> Dict[str, Any]:
    """The base model's tree of ``params``: itself, or the subtree under
    ``config``'s ``base_model_prefix``.  An XLM-R tree wrapped under
    ``roberta`` (the attribute name of ``transformers``' XLM-R heads) is
    refused: ``FlaxAutoModel`` looks for ``xlm-roberta`` there, finds no
    weights and initialises the model at random, which the port cannot
    reproduce."""
    from .encoders import BASE_MODEL_PREFIX

    if "embeddings" in params:
        return params
    prefix = BASE_MODEL_PREFIX.get(str(config.get("model_type")))
    if prefix is not None and isinstance(params.get(prefix), dict):
        return params[prefix]
    raise ValueError(
        f"{FLAX_WEIGHTS} holds no base-model weights for model_type "
        f"{config.get('model_type')!r} (top-level keys {sorted(params)}); "
        f"FlaxAutoModel would initialise them at random"
    )


def write_checkpoint(
    model_dir: Union[str, Path], config: Dict[str, Any], params: Dict[str, Any]
) -> None:
    """Write ``config.json`` and ``flax_model.msgpack`` (a checkpoint made
    from a seed)."""
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    (model_dir / CONFIG).write_text(json.dumps(config, indent=2), encoding="utf-8")
    chunks: List[Any] = []
    _pack_chunks(params, chunks)
    with open(model_dir / FLAX_WEIGHTS, "wb") as f:
        for chunk in chunks:
            f.write(chunk)
