"""Block-paged KV cache: static pools, a host-side block allocator, and the
view the model's attention core writes and reads through (counterpart:
``automodel_tpu/serving/kv_cache.py``).

Each layer keeps one pool of fixed-size blocks, ``k/v: [num_blocks,
block_size, Hk, D]`` (position-major), stacked over layers as ``[L, ...]``.
A request's block table maps position ``p`` to slot ``p % block_size`` of
block ``table[p // block_size]``.  Block 0 is the reserved null page: pad
tokens write into it and pad table entries point at it, so shapes stay
static and context-length masks keep it from being read.

``kv_cache_dtype: int8`` stores the pools quantized with per-slot per-kv-
head scale planes ``[L, num_blocks, block_size, Hk]``.

Unlike the JAX engine, which donates the pools through its jitted step,
the port updates them IN PLACE (``index_copy_`` into the per-layer view):
PyTorch runs eagerly and owns the buffers outright.

**Prefix caching** (``serving.prefix_caching: on``) shares committed
blocks across requests, as in JAX: :class:`BlockAllocator` counts the
holders of every live block (``free`` is a decref) and
:class:`PrefixIndex` keys each FULL committed block by the hash chain
``sha256(parent_key, block's token ids)`` -- byte for byte the JAX keys,
rooted per adapter so tenants never share KV.  A refcount-zero indexed
block parks in a warm LRU (still on the free ledger) and is evicted only
when the allocator needs it.  The last block of a fully cached sequence is
copy-on-write: :func:`cow_copy_blocks` copies it, with its int8 scale
planes, into a private block before the step's writes land.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from automodel_tpu_torch.ops.quant import INT8_MAX, quant_cast

KV_CACHE_DTYPES = ("auto", "int8")
DEFAULT_KV_CACHE_DTYPE = "auto"

# ``serving.prefix_caching``: YAML on/off are bool literals, so real bools
# map back onto the mode names before the membership check
PREFIX_CACHING_MODES = ("off", "on")
DEFAULT_PREFIX_CACHING = "off"


def normalize_null_spelling(v):
    """YAML null spellings ("none", "null", "") mean the default."""
    if isinstance(v, str) and v.lower() in ("none", "null", ""):
        return None
    return v


def normalize_kv_cache_dtype(v):
    return normalize_null_spelling(v)


def validate_kv_cache_dtype(v: Optional[str]) -> Optional[str]:
    if v is None:
        return None
    if v not in KV_CACHE_DTYPES:
        raise ValueError(
            f"serving.kv_cache_dtype must be one of {list(KV_CACHE_DTYPES)} "
            f"(or null for the default), got {v!r}")
    return v


def normalize_prefix_caching(v):
    v = normalize_null_spelling(v)
    if isinstance(v, bool):
        return "on" if v else "off"
    return v


def validate_prefix_caching(v: Optional[str]) -> Optional[str]:
    if v is None:
        return None
    if v not in PREFIX_CACHING_MODES:
        raise ValueError(
            f"serving.prefix_caching must be one of "
            f"{list(PREFIX_CACHING_MODES)} (YAML on/off/true/false, or "
            f"null for the default), got {v!r}")
    return v


class OutOfBlocks(RuntimeError):
    """KV pool exhausted -- the scheduler turns this into a preemption."""


class BlockAllocator:
    """Host-side free ledger over the pool's block ids with a holder count
    per live block.  Block 0 is the null page and is never handed out;
    blocks are handed out in the same order as the JAX allocator's, so both
    schedulers plan the same tables.  ``allocate`` hands out blocks at
    refcount 1, :meth:`incref` adds a holder (a prefix hit), :meth:`free`
    is a decref: a block rejoins the ledger when its last holder lets go
    (parked warm when the prefix index still maps it).  :attr:`all_free`
    is the leak check; warm blocks count as free."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 KV blocks (1 null + 1 usable), got {num_blocks}")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._free_set = set(self._free)
        self._refs: Dict[int, int] = {}      # live block -> holder count
        self.prefix_index: Optional["PrefixIndex"] = None
        self.peak_used = 0
        self.failed_allocs = 0

    @property
    def free_blocks(self) -> int:
        # the plain free list plus index-warmed refcount-zero blocks
        return len(self._free_set)

    @property
    def used_blocks(self) -> int:
        return (self.num_blocks - 1) - len(self._free_set)

    @property
    def all_free(self) -> bool:
        """True when every allocable block is back on the free ledger (the
        leak check after every request reached a terminal state)."""
        return len(self._free_set) == self.num_blocks - 1

    def ref_count(self, block: int) -> int:
        """Holders of ``block`` (0 when free or warm)."""
        return self._refs.get(block, 0)

    def allocate(self, n: int) -> List[int]:
        """``n`` block ids at refcount 1, or :class:`OutOfBlocks` with
        nothing handed out.  Uncached free blocks go first; then the prefix
        index evicts its least recently parked warm block."""
        if n > len(self._free_set):
            self.failed_allocs += 1
            raise OutOfBlocks(
                f"KV pool exhausted: requested {n} blocks, "
                f"{len(self._free_set)} free of {self.num_blocks - 1}")
        out = []
        for _ in range(n):
            b = (self._free.pop() if self._free
                 else self.prefix_index.evict_lru())
            self._refs[b] = 1
            out.append(b)
        self._free_set.difference_update(out)
        self.peak_used = max(self.peak_used, self.used_blocks)
        return out

    def incref(self, blocks: List[int]) -> None:
        """One more holder of each live block."""
        for b in blocks:
            if b not in self._refs:
                raise ValueError(f"incref of non-live block {b}")
            self._refs[b] += 1

    def revive(self, block: int) -> None:
        """A prefix hit on a warm refcount-zero block: off the free ledger
        at refcount 1 (the index has dropped it from its LRU)."""
        if block not in self._free_set:
            raise ValueError(f"revive of non-free block {block}")
        self._free_set.discard(block)
        self._refs[block] = 1
        self.peak_used = max(self.peak_used, self.used_blocks)

    def free(self, blocks: List[int]) -> None:
        """Decref each block; at zero it rejoins the free ledger."""
        if len(set(blocks)) != len(blocks):
            raise ValueError(f"duplicate block ids in free(): {blocks}")
        for b in blocks:
            if not 1 <= b < self.num_blocks:
                raise ValueError(f"freeing unknown block id {b}")
            if b in self._free_set:
                raise ValueError(f"double free of block {b}")
        for b in blocks:
            self._refs[b] -= 1
            if self._refs[b] > 0:
                continue
            del self._refs[b]
            self._free_set.add(b)
            if not (self.prefix_index is not None
                    and self.prefix_index.retain_freed(b)):
                self._free.append(b)


class PrefixIndex:
    """Content-hash index over FULL committed KV blocks.  Each entry keys
    one block by ``sha256(parent_key || block's token ids as int64)``, so a
    lookup walks the chain key by key.  A live block is never evicted; at
    refcount zero an indexed block parks in the warm LRU (``lru_blocks``
    bounds it, None keeps every free block warm); the allocator evicts
    warm blocks only when its plain free list runs dry, and :meth:`flush`
    forgets everything (the watchdog zeroes the pools)."""

    def __init__(self, allocator: BlockAllocator, *, block_size: int,
                 lru_blocks: Optional[int] = None):
        self.allocator = allocator
        allocator.prefix_index = self
        self.block_size = block_size
        self.lru_blocks = lru_blocks
        self._by_key: Dict[str, int] = {}
        self._by_block: Dict[int, str] = {}
        self._cached_free: "OrderedDict[int, None]" = OrderedDict()
        self.lookups = 0
        self.hits = 0
        self.misses = 0
        self.insertions = 0
        self.evictions = 0

    @staticmethod
    def chain_key(parent_key: Optional[str], tokens) -> str:
        h = hashlib.sha256()
        h.update((parent_key or "").encode("ascii"))
        h.update(np.asarray(list(tokens), dtype=np.int64).tobytes())
        return h.hexdigest()

    @staticmethod
    def root_key(adapter_id: int = 0) -> Optional[str]:
        """Chain root of a tenant: adapters change k/v, so a hit across
        tenants would leak one tenant's KV to another.  Base traffic roots
        at None."""
        return None if adapter_id == 0 else "adapter:%d" % int(adapter_id)

    def chain_keys(self, tokens, adapter_id: int = 0) -> List[str]:
        """The chain keys of every FULL block of ``tokens``, rooted in
        ``adapter_id``'s namespace."""
        bs = self.block_size
        keys: List[str] = []
        parent: Optional[str] = self.root_key(adapter_id)
        for i in range(len(tokens) // bs):
            parent = self.chain_key(parent, tokens[i * bs:(i + 1) * bs])
            keys.append(parent)
        return keys

    def has_key(self, key: str) -> bool:
        return key in self._by_key

    def peek(self, keys: List[str]) -> int:
        """Length of the cached leading chain; takes no refs."""
        n = 0
        for k in keys:
            if k not in self._by_key:
                break
            n += 1
        return n

    def acquire(self, keys: List[str]) -> List[int]:
        """One ref on each block of the longest cached leading chain (warm
        blocks revived, live ones increfed); returns their ids."""
        self.lookups += 1
        chain: List[int] = []
        for k in keys:
            b = self._by_key.get(k)
            if b is None:
                break
            if b in self._cached_free:
                del self._cached_free[b]
                self.allocator.revive(b)
            else:
                self.allocator.incref([b])
            chain.append(b)
        if chain:
            self.hits += 1
        else:
            self.misses += 1
        return chain

    def commit(self, parent_key: Optional[str], tokens, block_id: int) -> str:
        """Register one full block under its chain key; the first writer
        wins (``block_id`` then stays private).  Returns the key."""
        key = self.chain_key(parent_key, tokens)
        if key in self._by_key or block_id in self._by_block:
            return key
        self._by_key[key] = block_id
        self._by_block[block_id] = key
        self.insertions += 1
        return key

    def retain_freed(self, block: int) -> bool:
        """Allocator hook at refcount zero: park an indexed block warm
        (True) or decline (False: the plain free list).  Past
        ``lru_blocks`` the coldest warm blocks go back to the free list."""
        if block not in self._by_block:
            return False
        self._cached_free[block] = None
        if self.lru_blocks is not None:
            while len(self._cached_free) > self.lru_blocks:
                self.allocator._free.append(self.evict_lru())
        return True

    def evict_lru(self) -> int:
        """Drop the least recently parked warm entry; returns its block."""
        b, _ = self._cached_free.popitem(last=False)
        del self._by_key[self._by_block.pop(b)]
        self.evictions += 1
        return b

    @property
    def cached_blocks(self) -> int:
        return len(self._by_key)

    def flush(self) -> None:
        """Forget every entry; warm blocks rejoin the plain free list."""
        self.allocator._free.extend(self._cached_free)
        self._cached_free.clear()
        self._by_key.clear()
        self._by_block.clear()


def cow_copy_blocks(pools: Dict[str, torch.Tensor], src: torch.Tensor,
                    dst: torch.Tensor) -> None:
    """The copy-on-write fork, in place: block ``src[b]`` onto ``dst[b]``
    in every pool plane and layer (int8 scale planes ride the same block
    ids).  Rows without a fork carry ``(0, 0)``: the null page onto
    itself, a content no-op, so repeated index 0 writes are harmless.  One
    indexed copy per plane, on the current stream, before the step's
    writes."""
    for pool in pools.values():
        pool[:, dst] = pool[:, src]


def init_paged_pools(*, num_layers: int, num_kv_heads: int, head_dim: int,
                     num_blocks: int, block_size: int,
                     cache_dtype: torch.dtype, quantized: bool,
                     device) -> Dict[str, torch.Tensor]:
    """Zeroed per-layer-stacked pools ``{"k"|"v": [L, NB, BS, Hk, D]}``, plus
    ``{"k_scale"|"v_scale": [L, NB, BS, Hk]}`` fp32 when quantized."""
    shape = (num_layers, num_blocks, block_size, num_kv_heads, head_dim)
    dtype = torch.int8 if quantized else cache_dtype
    pools = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if quantized:
        pools["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device)
        pools["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device)
    return pools


def pool_bytes(pools: Dict[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in pools.values())


@dataclasses.dataclass
class PagedKVView:
    """The paged cache as one model forward sees it: the pools plus this
    step's addressing tensors (shared by every layer).  ``layer_view``
    narrows the stacked pools to one layer (views: writes land in the
    stacked tensors)."""

    pools: Dict[str, torch.Tensor]
    block_tables: torch.Tensor     # [B, MB] int32
    slot_mapping: torch.Tensor     # [B, S] int64 flat slot per written token
    context_lens: torch.Tensor     # [B] int32, INCLUDING this step's writes
    positions: torch.Tensor        # [B, S] int32 absolute query positions
    block_size: int = 16
    quantized: bool = False
    attn_impl: str = "kernel"      # see ops.paged_attention.paged_attention

    def layer_view(self, layer: int) -> "PagedKVView":
        return dataclasses.replace(
            self, pools={n: p[layer] for n, p in self.pools.items()})

    def write(self, k: torch.Tensor, v: torch.Tensor) -> None:
        """Scatter this step's ``[B, S, Hk, D]`` k/v into the (per-layer)
        pools at ``slot_mapping``, in place.  int8 pools quantize per
        written slot per kv head, storing the scale in the scale plane."""
        B, S, Hk, D = k.shape
        slots = self.slot_mapping.reshape(-1)
        for name, x in (("k", k), ("v", v)):
            pool = self.pools[name]
            flat = x.reshape(B * S, Hk, D)
            if self.quantized:
                amax = flat.float().abs().amax(dim=-1)
                sc = torch.clamp(amax, min=1e-12) / INT8_MAX    # [B*S, Hk]
                flat = quant_cast(flat, sc[..., None])
                self.pools[name + "_scale"].view(-1, Hk).index_copy_(
                    0, slots, sc)
            pool.view(-1, Hk, D).index_copy_(0, slots, flat.to(pool.dtype))

    def attend(self, q: torch.Tensor, k=None, v=None, *, scale=None,
               logits_soft_cap=None, local_window_size=None,
               impl=None) -> torch.Tensor:
        """Paged attention of ``q [B, S, Hq, D]`` over the (freshly written)
        pools.  ``k`` / ``v`` and ``impl`` are taken for the dense view's
        signature and unused: the keys are in the pools, and the engine
        chose the route (``attn_impl``)."""
        from automodel_tpu_torch.ops.paged_attention import paged_attention

        return paged_attention(
            q, self.pools["k"], self.pools["v"],
            k_scale=self.pools.get("k_scale"),
            v_scale=self.pools.get("v_scale"),
            block_tables=self.block_tables, context_lens=self.context_lens,
            positions=self.positions, scale=scale,
            logits_soft_cap=logits_soft_cap,
            local_window_size=local_window_size, impl=self.attn_impl)


def slot_for(block_table: List[int], position: int, block_size: int) -> int:
    """Flat pool slot of ``position`` under a request's block table."""
    return block_table[position // block_size] * block_size \
        + position % block_size


def blocks_needed(tokens: int, block_size: int) -> int:
    return -(-tokens // block_size)
