"""Reading (and writing) a Hugging Face Flax checkpoint with no
``transformers``, ``flax`` or ``msgpack``: the files ``svs_tpu``'s local
provider loads through ``FlaxAutoModel.from_pretrained``.

- :func:`resolve_model_dir` — a local directory, or a hub name that is
  already in the local Hugging Face cache (``$HF_HUB_CACHE``, else
  ``$HF_HOME/hub``, else ``~/.cache/huggingface/hub``:
  ``models--org--name/snapshots/<refs/main>``).  Nothing is downloaded.
- :func:`load_checkpoint` — ``config.json`` and ``flax_model.msgpack``,
  or a sharded checkpoint (``flax_model.msgpack.index.json`` and the
  ``flax_model-0000k-of-0000n.msgpack`` files it names, read one at a
  time): the parameter tree as NumPy arrays.
- :func:`unpackb` / :func:`packb` — the part of MessagePack that Flax's
  ``msgpack_serialize`` writes: maps, arrays, strings, binaries, numbers,
  ext type 1 = an ndarray (``(shape, dtype name, C-order bytes)``, itself
  MessagePack; bf16 leaves read as f32, converted on torch's threads); an
  array past 2^30 bytes is stored as a ``{'__msgpack_chunked_array__':
  True, 'shape', 'chunks'}`` dict of 1-D chunks of at most 2^30 bytes
  (``flax.serialization._chunk``), joined back on reading and written so.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

FLAX_WEIGHTS = "flax_model.msgpack"
#: The index of a sharded checkpoint (``save_pretrained(max_shard_size=)``).
FLAX_WEIGHTS_INDEX = "flax_model.msgpack.index.json"
CONFIG = "config.json"
_EXT_NDARRAY = 1
_CHUNKED = "__msgpack_chunked_array__"
#: ``flax.serialization.MAX_CHUNK_SIZE``: a larger leaf is written in chunks.
MAX_CHUNK_BYTES = 1 << 30


# -- MessagePack ----------------------------------------------------------------


class _Reader:
    def __init__(self, buf: Union[bytes, bytearray, memoryview], views: bool = False) -> None:
        self.buf = memoryview(buf)
        self.pos = 0
        self.views = views  # binaries as views of ``buf`` (an ndarray's data)

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
            data = self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b]))
            return data if self.views else bytes(data)
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
        # the data stays a view of the buffer: no copy, and writable arrays
        # when the buffer is (a file's copy-on-write mapping)
        shape, dtype, buffer = _Reader(data, views=True).obj(raw=True)
        name = bytes(dtype).decode() if isinstance(dtype, (bytes, memoryview)) else dtype
        if name == "bfloat16":
            arr = _bf16_to_f32(np.frombuffer(buffer, dtype="<u2"))
        else:
            arr = np.frombuffer(buffer, dtype=np.dtype(name))
        return arr.reshape(shape)


def _bf16_to_f32(words: np.ndarray) -> np.ndarray:
    """bf16 words as f32 (exact), a new writable array.  torch's
    conversion runs on all its threads: a 7B checkpoint's 7.1G words take
    seconds, not the minute of a single-threaded NumPy shift."""
    with warnings.catch_warnings():  # a read-only buffer, only read here
        warnings.simplefilter("ignore", UserWarning)
        src = torch.from_numpy(np.ascontiguousarray(words).view(np.int16))
    return src.view(torch.bfloat16).float().numpy()


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if tree.get(_CHUNKED) is True:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data: Union[bytes, bytearray, memoryview]) -> Any:
    """Decode a Flax ``msgpack_serialize`` blob: nested dicts of NumPy
    arrays (views of ``data``, writable when it is; bf16 leaves as new f32
    arrays), chunked arrays joined."""
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


def _leaf(obj: Any) -> Tuple[np.ndarray, str]:
    """``(the leaf's C-order data as an ndarray, its dtype name)``; a torch
    tensor's data is viewed (bf16 as its 16-bit words, which NumPy lacks)."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), name
        return t.numpy(), name
    arr = np.ascontiguousarray(obj)
    return arr, arr.dtype.name


def _pack_chunks(obj: Any, chunks: List[Any]) -> None:
    """:func:`_pack` into a list of byte chunks, an array's data as a
    view of the array (no copy: a checkpoint of 2 GB is written as it is
    held).  Leaves are NumPy arrays or torch tensors (bf16 is written as
    Flax writes it)."""
    if isinstance(obj, dict):
        head = bytearray(b"\xdf" + struct.pack(">I", len(obj)))
        chunks.append(head)
        for key, value in obj.items():
            _pack(key, head)
            if isinstance(value, (dict, np.ndarray, torch.Tensor)):
                _pack_chunks(value, chunks)
                head = bytearray()
                chunks.append(head)
            else:
                _pack(value, head)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        arr, name = _leaf(obj)
        if arr.nbytes <= MAX_CHUNK_BYTES:
            _pack_array(arr, name, chunks)
            return
        # Flax's _chunk: the flat array's slices of at most MAX_CHUNK_BYTES
        flat, step = arr.reshape(-1), max(1, MAX_CHUNK_BYTES // arr.itemsize)
        parts = [flat[i:i + step] for i in range(0, flat.size, step)]
        head = bytearray(b"\xdf" + struct.pack(">I", 3))
        for item in (_CHUNKED, True, "shape", {str(i): int(d) for i, d in enumerate(arr.shape)},
                     "chunks"):
            _pack(item, head)
        head += b"\xdf" + struct.pack(">I", len(parts))
        chunks.append(head)
        for i, part in enumerate(parts):
            key = bytearray()
            _pack(str(i), key)
            chunks.append(key)
            _pack_array(part, name, chunks)
    else:
        head = bytearray()
        _pack(obj, head)
        chunks.append(head)


def _pack_array(arr: np.ndarray, name: str, chunks: List[Any]) -> None:
    """One ext-1 ndarray (``arr``'s C-order data, its dtype ``name``), the
    data as a view."""
    inner = bytearray(b"\xdd" + struct.pack(">I", 3))
    _pack([int(s) for s in arr.shape], inner)
    _pack(name, inner)
    inner += b"\xc6" + struct.pack(">I", arr.nbytes)
    chunks.append(b"\xc9" + struct.pack(">I", len(inner) + arr.nbytes)
                  + struct.pack(">b", _EXT_NDARRAY) + bytes(inner))
    chunks.append(memoryview(arr.reshape(-1)).cast("B"))


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


def _read_file(path: Path) -> Union[bytes, mmap.mmap]:
    """The whole file as a private copy-on-write mapping: the arrays
    unpacked from it are writable views of the page cache (the encoder
    takes them with no copy, and a 10 GB shard costs no 10 GB buffer)."""
    if path.stat().st_size == 0:
        return b""
    with open(path, "rb") as f:
        return mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)


def _flatten(tree: Dict[str, Any], prefix: str, out: Dict[str, Any]) -> None:
    for key, value in tree.items():
        if isinstance(value, dict):
            _flatten(value, f"{prefix}{key}/", out)
        else:
            out[prefix + key] = value


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def shard_files(model_dir: Union[str, Path]) -> List[Path]:
    """The weight files of a checkpoint, in the order
    ``FlaxPreTrainedModel.from_pretrained`` reads them: ``flax_model.msgpack``
    when there is one, else the sorted shard names of
    ``flax_model.msgpack.index.json``."""
    model_dir = Path(model_dir)
    if (model_dir / FLAX_WEIGHTS).is_file():
        return [model_dir / FLAX_WEIGHTS]
    index = model_dir / FLAX_WEIGHTS_INDEX
    if not index.is_file():
        raise FileNotFoundError(
            f"no {FLAX_WEIGHTS} or {FLAX_WEIGHTS_INDEX} in {model_dir} "
            "(svs_tpu's local provider loads Flax checkpoints, and so does the port)"
        )
    weight_map = json.loads(index.read_text(encoding="utf-8"))["weight_map"]
    files = [model_dir / name for name in sorted(set(weight_map.values()))]
    missing = [str(f) for f in files if not f.is_file()]
    if missing:
        raise FileNotFoundError(f"{index} names shards that are missing: {missing}")
    return files


def load_checkpoint(model_dir: Union[str, Path]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(config, params)``: ``config.json`` and the Flax parameter tree of
    ``flax_model.msgpack``, or of the shards a ``flax_model.msgpack.index.json``
    names (NumPy arrays).  Shards are read one at a time, as
    ``FlaxPreTrainedModel.load_flax_sharded_weights`` reads them: each
    flattened with ``/`` and merged, then the whole unflattened; a shard of
    bf16 leaves is freed once its leaves are f32 arrays.  A head model's
    checkpoint holds the base model under its family's
    ``base_model_prefix`` (:data:`.encoders.BASE_MODEL_PREFIX`: ``bert``,
    ``roberta``, ...; ``model`` for the ``*ForCausalLM`` trees of Llama,
    Mistral, Gemma and XGLM and for the ``*ForConditionalGeneration`` trees
    of BART, mBART, Pegasus, Blenderbot and Blenderbot-small,
    ``transformer`` for GPT-2's, GPT-Neo's, GPT-J's and BLOOM's), and that
    wrapper is unwrapped as
    ``FlaxAutoModel.from_pretrained`` unwraps it (:func:`unwrap_head`)."""
    config = read_config(model_dir)
    files = shard_files(model_dir)
    if len(files) == 1:
        params = unpackb(_read_file(files[0]))
    else:
        flat: Dict[str, Any] = {}
        for path in files:
            _flatten(unpackb(_read_file(path)), "", flat)
        params = _unflatten(flat)
    return config, unwrap_head(config, params)


def unwrap_head(config: Dict[str, Any], params: Dict[str, Any]) -> Dict[str, Any]:
    """The base model's tree of ``params``: itself when it holds the base
    model's embeddings at its top (``embeddings``; a decoder's
    ``embed_tokens``, ``wte`` or ``word_embeddings``; an encoder-decoder's
    ``shared``: :data:`.encoders.BASE_TREE_KEY`), else the subtree under
    ``config``'s ``base_model_prefix`` (a ``*ForCausalLM`` /
    ``*LMHeadModel`` tree's ``model`` or ``transformer``, its ``lm_head``
    left out; a ``*ForConditionalGeneration`` tree's ``model``, its
    ``final_logits_bias`` and untied ``lm_head`` left out).  An XLM-R tree
    wrapped under ``roberta`` (the attribute name of ``transformers``' XLM-R
    heads) is refused: ``FlaxAutoModel`` looks for ``xlm-roberta`` there,
    finds no weights and initialises the model at random, which the port
    cannot reproduce."""
    from .encoders import BASE_MODEL_PREFIX, BASE_TREE_KEY

    model_type = str(config.get("model_type"))
    if BASE_TREE_KEY.get(model_type, "embeddings") in params:
        return params
    prefix = BASE_MODEL_PREFIX.get(model_type)
    if prefix is not None and isinstance(params.get(prefix), dict):
        return params[prefix]
    raise ValueError(
        f"the checkpoint holds no base-model weights for model_type "
        f"{config.get('model_type')!r} (top-level keys {sorted(params)}); "
        f"FlaxAutoModel would initialise them at random"
    )


def _nbytes(leaf: Any) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(np.asarray(leaf).nbytes)


class _FileSink:
    """The chunk list of :func:`_pack_chunks`, written as it grows: only
    the last chunk can still change (a map's header takes its keys), so
    each chunk goes to the file when the next one comes.  A leaf's data
    (a torch tensor copied off the card) is held one leaf at a time."""

    def __init__(self, f: Any) -> None:
        self.f, self.last = f, None

    def append(self, chunk: Any) -> None:
        if self.last is not None:
            self.f.write(self.last)
        self.last = chunk

    def close(self) -> None:
        if self.last is not None:
            self.f.write(self.last)
        self.last = None


def _write_tree(path: Path, tree: Dict[str, Any]) -> None:
    with open(path, "wb") as f:
        sink = _FileSink(f)
        _pack_chunks(tree, sink)  # type: ignore[arg-type]
        sink.close()


def write_checkpoint(
    model_dir: Union[str, Path],
    config: Dict[str, Any],
    params: Dict[str, Any],
    max_shard_size: Optional[int] = None,
) -> List[Path]:
    """Write ``config.json`` and the weights (a checkpoint made from a
    seed): ``flax_model.msgpack``, or, with ``max_shard_size`` (bytes) and
    a tree larger than it, the shards and index that
    ``save_pretrained(max_shard_size=...)`` writes (``flax_shard_checkpoint``:
    leaves in the tree's order, a new shard before a leaf that would pass
    the size).  Leaves are NumPy arrays or torch tensors (bf16 written as
    Flax writes it).  Returns the weight files written."""
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    (model_dir / CONFIG).write_text(json.dumps(config, indent=2), encoding="utf-8")
    flat: Dict[str, Any] = {}
    _flatten(params, "", flat)
    shards: List[Dict[str, Any]] = []
    block: Dict[str, Any] = {}
    size = total = 0
    for key, leaf in flat.items():
        n = _nbytes(leaf)
        if max_shard_size is not None and size + n > max_shard_size:
            shards.append(block)  # as Flax, even an empty first block
            block, size = {}, 0
        block[key] = leaf
        size += n
        total += n
    shards.append(block)
    if len(shards) == 1:
        _write_tree(model_dir / FLAX_WEIGHTS, params)
        return [model_dir / FLAX_WEIGHTS]
    names = [FLAX_WEIGHTS.replace(".msgpack", f"-{i + 1:05d}-of-{len(shards):05d}.msgpack")
             for i in range(len(shards))]
    index = {"metadata": {"total_size": total},
             "weight_map": {key: name for name, shard in zip(names, shards) for key in shard}}
    (model_dir / FLAX_WEIGHTS_INDEX).write_text(json.dumps(index, indent=2, sort_keys=True) + "\n",
                                                encoding="utf-8")
    for name, shard in zip(names, shards):
        _write_tree(model_dir / name, _unflatten(shard))
    return [model_dir / name for name in names]
