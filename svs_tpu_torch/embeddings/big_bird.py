"""A BigBird encoder (``model_type: "big_bird"``) in plain PyTorch: the
forward pass of ``transformers``' ``FlaxBigBirdModel`` up to
``last_hidden_state``, as ``svs_tpu``'s local provider runs it (inference:
``train=False``).

The stack is :mod:`.bert`'s (post-LN layers, BERT-style embeddings with
positions 0, 1, ... and token types all 0, the word embeddings times
``sqrt(hidden_size)`` with ``rescale_embeddings``).  With
``attention_type: "original_full"`` each layer's self-attention is BERT's;
with ``"block_sparse"`` (the published checkpoints' default) it is
:func:`block_sparse_attention`, ``FlaxBigBirdBlockSparseAttention``'s
computation in five query parts over blocks of ``block_size`` tokens
(``modeling_flax_big_bird.py:529-800``):

- the first and the last query block attend every key;
- the second (the second last) attends key blocks 0, 1, 2 (0, -3, -2)
  and the last block, then its ``num_random_blocks`` "random" blocks;
- each middle block ``i`` attends the first block, the sliding blocks
  ``i-1, i, i+1``, its random blocks and the last block.

What a port that follows the paper rather than the code gets wrong:

- **the "random" blocks are block 0 in inference.**  With
  ``deterministic=True`` both plans (``_bigbird_block_rand_mask`` for
  ``L`` in 1,024 / 3,072 / 4,096, ``_bigbird_block_rand_mask_with_head``
  otherwise) are zeros, so every random block gathers key block 0, which
  then sits in the softmax once as a global block and again once per
  random block (:func:`random_plan`);
- the mask penalty is ``-10000.0`` added to the scaled scores, not the f32
  minimum of BERT's bias, and padded query rows are zeroed after the
  product;
- there is no switch to full attention for short inputs: Flax runs
  block-sparse at any ``L`` that is a multiple of ``block_size``.  It
  fails below four blocks (two: integer modulo by zero; three: a reshape
  error), for every ``num_random_blocks``; the port raises
  ``NotImplementedError`` naming the block count there
  (:func:`check_blocks`), and ``ValueError`` when ``L`` is not a multiple
  of ``block_size``, as Flax does.

The port computes the same sums in two products a layer (the first and
last query blocks against every key; every other query block against its
gathered key blocks, :func:`block_layout`) instead of Flax's five parts
and their concatenations.  The attention is gathers, matrix products and
softmax, as it is XLA code outside any Pallas kernel in the JAX package:
no kernel of this repository.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch
from torch import nn

from . import bert
from .bert import Linear

#: ``attn_mask_penalty`` of ``bigbird_block_sparse_attention``.
MASK_PENALTY = -10000.0
#: Sequence lengths that take the paper's plan (``_bigbird_block_rand_mask``).
PAPER_LENGTHS = (1024, 3072, 4096)
#: Flax's block-sparse attention fails below this many blocks.
MIN_BLOCKS = 4
ATTENTION_TYPES = ("original_full", "block_sparse")


def check_config(config: Dict[str, Any]) -> None:
    """Refuse what this encoder does not compute, naming it."""
    if config.get("model_type") != "big_bird":
        raise NotImplementedError(f"model_type {config.get('model_type')!r} is not big_bird")
    bert.check_config(config)
    kind = config.get("attention_type", "block_sparse")
    if kind not in ATTENTION_TYPES:
        raise NotImplementedError(f"BigBird attention_type {kind!r} is not ported")
    if kind == "block_sparse" and not config.get("use_bias", True):
        raise NotImplementedError("BigBird use_bias=False is not ported")
    if config.get("is_decoder") or config.get("add_cross_attention"):
        raise NotImplementedError("a BigBird decoder is not ported")


def check_blocks(seq_len: int, block_size: int) -> None:
    """Raise where ``FlaxBigBirdBlockSparseAttention`` fails: ``ValueError``
    when ``seq_len`` is not a multiple of ``block_size`` (Flax's own error),
    ``NotImplementedError`` below :data:`MIN_BLOCKS` blocks (where Flax
    crashes in its index arithmetic)."""
    if seq_len % block_size:
        raise ValueError(
            f"Sequence length must be multiple of block size, but sequence length is "
            f"{seq_len}, while block size is {block_size}."
        )
    blocks = seq_len // block_size
    if blocks < MIN_BLOCKS:
        raise NotImplementedError(
            f"BigBird block-sparse attention over {blocks} blocks of block_size "
            f"{block_size} (sequence length {seq_len}) is not ported: the reference fails "
            f"below {MIN_BLOCKS} blocks; use max_length >= {MIN_BLOCKS * block_size} "
            f"or attention_type='original_full'"
        )


def random_plan(seq_len: int, block_size: int, n_rand: int, max_positions: int) -> torch.Tensor:
    """``[blocks - 2, n_rand]`` key block of each random block of query
    blocks 1 .. blocks-2 in inference: zeros (both of Flax's plans return
    ``jnp.zeros`` when deterministic).  At the paper's lengths the plan is
    cut from one made for ``max_position_embeddings``, which must have the
    rows (else Flax's reshape fails, and so does this)."""
    blocks = seq_len // block_size
    rows = blocks - 2
    if seq_len in PAPER_LENGTHS:
        rows = min(rows, max_positions // block_size - 2)
    if rows != blocks - 2:
        raise NotImplementedError(
            f"BigBird's plan for {blocks} blocks of block_size {block_size} has {rows} rows "
            f"(max_position_embeddings {max_positions}): the reference fails there"
        )
    return torch.zeros(rows, n_rand, dtype=torch.long)


class BlockLayout(NamedTuple):
    """What every layer's block-sparse attention needs of one batch's mask
    (:func:`block_layout`; built once a forward pass)."""

    #: ``[blocks - 2, 5 + r]`` key blocks of query blocks 1 .. blocks-2
    idx: torch.Tensor
    #: ``[B, 1, blocks - 2, 1, (5 + r) * block_size]`` f32 additive mask
    bias: torch.Tensor
    #: ``[B, 1, 1, L]`` f32 additive mask of the first and last query blocks
    global_bias: torch.Tensor
    #: ``[B, 1, L, 1]`` 0/1: padded query rows come out 0
    from_mask: torch.Tensor
    block_size: int


def block_layout(mask: torch.Tensor, block_size: int, plan: torch.Tensor) -> BlockLayout:
    """The key blocks each query block attends and their additive masks,
    from a ``[B, L]`` 0/1 mask and the random plan (:func:`random_plan`).

    Query block ``j`` in 1 .. blocks-2 attends ``5 + r`` key blocks, in
    one row of ``idx``: the first block, its sliding blocks ``j-1, j,
    j+1``, its random blocks ``plan[j-1]`` and the last block.  Flax's
    second and second-last blocks attend ``4 + r`` (``0, 1, 2, -1`` and
    ``0, -3, -2, -1``, then the random blocks): their rows hold the same
    blocks and one more that is masked out, whose weight underflows to
    exactly 0 as a padded key's does.  A key counts as many times as it
    is listed (block 0 once as the first block and once per random block).
    The masks are the keys' (penalty ``MASK_PENALTY``); Flax's masks of
    the sliding and random parts are also 0 on padded query rows, which
    changes only rows that are zeroed after the product."""
    bsz, seq_len = mask.shape
    bs, nb = block_size, seq_len // block_size
    r = plan.shape[1]
    rows, valid = [], []
    for j in range(1, nb - 1):
        rand = [int(x) for x in plan[j - 1]]
        if j == 1:  # (0, 1, 2, -1): the first block's own slot is the spare
            rows.append([0, 0, 1, 2, *rand, nb - 1])
            valid.append([1, 0] + [1] * (r + 3))
        elif j == nb - 2:  # (0, -3, -2, -1): the last block's own slot is the spare
            rows.append([0, nb - 3, nb - 2, nb - 1, *rand, nb - 1])
            valid.append([1] * (r + 4) + [0])
        else:
            rows.append([0, j - 1, j, j + 1, *rand, nb - 1])
            valid.append([1] * (r + 5))
    idx = torch.tensor(rows, dtype=torch.long).to(mask.device, non_blocking=True)
    keep = torch.tensor(valid, dtype=torch.float32).to(mask.device, non_blocking=True)
    bm = mask.to(torch.float32).reshape(bsz, nb, bs)
    keys = bm[:, idx] * keep[None, :, :, None]  # [B, nb - 2, 5 + r, bs]
    bias = ((1.0 - keys) * MASK_PENALTY).reshape(bsz, 1, nb - 2, 1, (r + 5) * bs)
    to_mask = mask.to(torch.float32).reshape(bsz, 1, 1, seq_len)
    return BlockLayout(idx, bias, (1.0 - to_mask) * MASK_PENALTY,
                       to_mask.reshape(bsz, 1, seq_len, 1), bs)


def _weights(scores: torch.Tensor, rsqrt_d: float, bias: torch.Tensor) -> torch.Tensor:
    """Softmax of ``scores * rsqrt_d + bias`` over the last axis, in the
    scores' dtype (in place: the bf16 scores of an autocast run are not
    copied to f32; the softmax accumulates in f32 whatever its dtype)."""
    scores.mul_(rsqrt_d).add_(bias)
    with torch.autocast(device_type=scores.device.type, enabled=False):
        return torch.softmax(scores, dim=-1)


def block_sparse_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, layout: BlockLayout
) -> torch.Tensor:
    """``bigbird_block_sparse_attention`` of ``[B, H, L, D]`` queries, keys
    and values (contiguous) over :func:`block_layout`'s blocks; ``[B, H,
    L, D]``, padded query rows 0.  Two products: the first and last query
    blocks against every key, then every other query block against its
    ``5 + r`` gathered key blocks; each as Flax computes its parts (the
    scores times ``1/sqrt(D)`` in f32's rounding, plus the mask, softmax,
    the weights times the values)."""
    bsz, heads, seq_len, dim = q.shape
    bs = layout.block_size
    nb = seq_len // bs
    m = layout.idx.shape[1]
    rsqrt_d = float(np.float32(1.0) / np.sqrt(np.float32(dim)))  # Flax's f32 constant
    bq = q.reshape(bsz, heads, nb, bs, dim)
    bk = k.reshape(bsz, heads, nb, bs, dim)
    bv = v.reshape(bsz, heads, nb, bs, dim)

    # the first and last query blocks: every key
    ends = torch.tensor([0, nb - 1], device=q.device)
    gq = bq.index_select(2, ends).reshape(bsz, heads, 2 * bs, dim)
    w = _weights(torch.matmul(gq, k.transpose(-1, -2)), rsqrt_d, layout.global_bias)
    ends_ctx = torch.matmul(w, v).reshape(bsz, heads, 2, bs, dim)

    # every other query block: its gathered key blocks
    flat = layout.idx.reshape(-1)
    keys = bk.index_select(2, flat).reshape(bsz, heads, nb - 2, m * bs, dim)
    vals = bv.index_select(2, flat).reshape(bsz, heads, nb - 2, m * bs, dim)
    w = _weights(torch.matmul(bq[:, :, 1:-1], keys.transpose(-1, -2)), rsqrt_d, layout.bias)
    mid_ctx = torch.matmul(w, vals)

    ctx = torch.cat([ends_ctx[:, :, :1], mid_ctx, ends_ctx[:, :, 1:]], dim=2)
    return ctx.reshape(bsz, heads, seq_len, dim) * layout.from_mask.to(ctx.dtype)


class BlockSparseSelfAttention(nn.Module):
    """``FlaxBigBirdBlockSparseAttention``: the query, key and value
    projections, then :func:`block_sparse_attention` over the config's
    ``block_size`` and ``num_random_blocks``."""

    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__()
        h = c["hidden_size"]
        self.heads = c["num_attention_heads"]
        self.head_dim = h // self.heads
        self.block_size = int(c.get("block_size", 64))
        self.n_rand = int(c.get("num_random_blocks", 3))
        self.max_positions = int(c["max_position_embeddings"])
        self.query = Linear(h, h)
        self.key = Linear(h, h)
        self.value = Linear(h, h)

    def layout(self, mask: torch.Tensor) -> BlockLayout:
        """:func:`block_layout` of a ``[B, L]`` 0/1 mask (the checks of
        :func:`check_blocks` first)."""
        n = mask.shape[1]
        check_blocks(n, self.block_size)
        return block_layout(
            mask, self.block_size, random_plan(n, self.block_size, self.n_rand, self.max_positions)
        )

    def forward(self, x: torch.Tensor, mask: Any) -> torch.Tensor:
        """``[B, L, hidden]`` and the ``[B, L]`` 0/1 mask or its
        :class:`BlockLayout`."""
        b, n, h = x.shape
        layout = mask if isinstance(mask, BlockLayout) else self.layout(mask)

        def heads(t: torch.Tensor) -> torch.Tensor:
            return t.view(b, n, self.heads, self.head_dim).transpose(1, 2).contiguous()

        ctx = block_sparse_attention(
            heads(self.query(x)), heads(self.key(x)), heads(self.value(x)), layout
        )
        return ctx.transpose(1, 2).reshape(b, n, h)


class BigBirdEncoder(bert.BertEncoder):
    """``FlaxBigBirdModel``'s ``last_hidden_state`` for a ``config.json``:
    :class:`.bert.BertEncoder` with :class:`BlockSparseSelfAttention` in
    every layer when ``attention_type`` is ``block_sparse`` (the layout of
    the blocks built once a forward pass)."""

    def __init__(self, config: Dict[str, Any]) -> None:
        check_config(config)
        sparse = config.get("attention_type", "block_sparse") == "block_sparse"
        super().__init__(config, BlockSparseSelfAttention if sparse else bert._SelfAttention)
        self.block_sparse = sparse

    def attention_mask(self, mask: torch.Tensor) -> Any:
        if self.block_sparse:
            return self.encoder.layer[0].attention.self.layout(mask)
        return super().attention_mask(mask)
