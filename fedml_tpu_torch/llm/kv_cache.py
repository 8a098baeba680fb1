"""Paged (block-allocated) KV cache for continuous-batching decode
(counterpart of ``fedml_tpu/llm/kv_cache.py``).

A vLLM-style paged cache (Kwon et al. 2023): the physical cache is a fixed
pool of ``num_blocks`` blocks of ``block_size`` key/value rows per layer,
plus one trailing TRASH block that absorbs writes from inactive slots and
padded prefill rows, so a step never branches on occupancy. Each slot owns
a block table ``[max_blocks]`` mapping logical position ``p`` to
``table[p // block_size]``; tables, positions and occupancy are data.

The device side is torch: pools are ``[L, num_blocks + 1, block_size, H,
D]`` tensors, :func:`gather_view` reads a slot's blocks into a
position-ordered dense view ``[T = max_seq_len]``, and the scatters write
a step's new K/V rows IN PLACE with ``index_put_`` — what buffer donation
gives the JAX package, and O(rows written), not O(pool). Out-of-range
reads cannot happen: XLA clamps gather indices, torch does not, so the
gather clamps table entries to ``[0, trash_block]`` and the scatters clip
positions as the JAX functions do.

Block allocation (refcounted, for shared-prefix aliasing) and the
shared-prefix index are host-side numpy bookkeeping, copied from the JAX
package: :class:`BlockAllocator` and :class:`PrefixIndex`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _stable_items(d: Dict, tries: int = 8) -> List[Tuple[Any, Any]]:
    """Snapshot a dict the engine worker mutates concurrently (handler
    threads read refcounts and index metadata for /metrics and
    /debug/state; iterating a dict that changes size raises RuntimeError).
    Retry a few times; an empty read beats a 500."""
    for _ in range(tries):
        try:
            return list(d.items())
        except RuntimeError:
            continue
    return []


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    """Static geometry of the paged pool."""

    num_layers: int
    kv_heads: int
    head_dim: int
    max_seq_len: int
    block_size: int = 16
    num_blocks: int = 256   # physical pool, shared across slots

    def __post_init__(self):
        if self.max_seq_len % self.block_size:
            raise ValueError(
                f"block_size {self.block_size} must divide max_seq_len "
                f"{self.max_seq_len}: the gathered view must be exactly "
                "max_seq_len keys for full-forward bit-compatibility")

    @property
    def max_blocks_per_slot(self) -> int:
        return self.max_seq_len // self.block_size

    @property
    def trash_block(self) -> int:
        """Sacrificial physical block: writes from inactive slots and
        padded prefill rows land here; unallocated table entries read it."""
        return self.num_blocks

    def blocks_needed(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.block_size)


def init_pools(cfg: KVCacheConfig, dtype: torch.dtype = torch.float32,
               device: Optional[torch.device] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeroed K and V pools ``[L, num_blocks + 1, block_size, H, D]``
    (the +1 is the trash block) on ``device`` (the CPU when None)."""
    shape = (cfg.num_layers, cfg.num_blocks + 1, cfg.block_size,
             cfg.kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def gather_view(pool_layer: torch.Tensor,
                tables: torch.Tensor) -> torch.Tensor:
    """``[NB+1, bs, H, D]`` pool + ``[..., max_blocks]`` tables →
    position-ordered dense view ``[..., T, H, D]`` (T = max_blocks * bs),
    a fresh tensor. Table entries are clamped into the pool, as XLA's
    gather clamps them."""
    idx = tables.long().clamp(0, pool_layer.shape[0] - 1)
    v = pool_layer[idx]                         # [..., max_blocks, bs, H, D]
    return v.reshape(v.shape[:-4] + (v.shape[-4] * v.shape[-3],)
                     + v.shape[-2:])


def _put(pool: torch.Tensor, layer: int, blk: torch.Tensor,
         off: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    pool.index_put_((torch.full_like(blk, int(layer)), blk, off),
                    values.to(pool.dtype))
    return pool


def scatter_token(pool: torch.Tensor, layer: int, tables: torch.Tensor,
                  positions: torch.Tensor, values: torch.Tensor,
                  active: torch.Tensor, block_size: int,
                  trash_block: int) -> torch.Tensor:
    """Write one new K or V row per slot at its logical position, in place
    into layer ``layer`` of the stacked pool ``[L, NB+1, bs, H, D]``;
    returns the pool. tables ``[S, max_blocks]``; positions ``[S]``;
    values ``[S, H, D]``; active ``[S]`` bool. Inactive slots' writes go to
    the trash block (several land on one row there; which one wins is
    undefined, as in XLA, and the row is only ever read under the mask).
    Active slots own disjoint blocks, so the scatter has no cross-slot
    conflicts."""
    s = tables.shape[0]
    pos = positions.long().clamp(0, tables.shape[1] * block_size - 1)
    blk = tables.long()[torch.arange(s, device=pool.device),
                        pos // block_size]
    blk = torch.where(active, blk, trash_block)
    return _put(pool, layer, blk, pos % block_size, values)


def scatter_chunk(pool: torch.Tensor, layer: int, table_row: torch.Tensor,
                  positions: torch.Tensor, values: torch.Tensor,
                  valid: torch.Tensor, block_size: int,
                  trash_block: int) -> torch.Tensor:
    """Write a prefill chunk's K or V rows for ONE slot into layer
    ``layer``, in place. table_row ``[max_blocks]``; positions ``[C]``
    (logical); values ``[C, H, D]``; valid ``[C]`` bool (padded chunk tail
    → trash)."""
    pos = positions.long().clamp(0, table_row.shape[0] * block_size - 1)
    blk = torch.where(valid, table_row.long()[pos // block_size],
                      trash_block)
    return _put(pool, layer, blk, pos % block_size, values)


def scatter_chunk_batch(pool: torch.Tensor, layer: int,
                        table_rows: torch.Tensor,
                        positions: torch.Tensor, values: torch.Tensor,
                        valid: torch.Tensor, block_size: int,
                        trash_block: int) -> torch.Tensor:
    """Write B slots' prefill chunks in ONE scatter (piggybacked prefill),
    in place. table_rows ``[B, max_blocks]``; positions ``[B, C]``;
    values ``[B, C, H, D]``; valid ``[B, C]``. Rows of an admission wave
    own disjoint fresh blocks (aliased prefix blocks are never written),
    so the flattened scatter has no cross-row conflicts; invalid rows land
    in the trash block."""
    b, c = positions.shape
    pos = positions.long().clamp(0, table_rows.shape[1] * block_size - 1)
    blk = torch.gather(table_rows.long(), 1, pos // block_size)
    blk = torch.where(valid, blk, trash_block).reshape(-1)
    flat = values.reshape((b * c,) + tuple(values.shape[2:]))
    return _put(pool, layer, blk, (pos % block_size).reshape(-1), flat)


def copy_block_rows(pool: torch.Tensor, src, dst, n_rows) -> torch.Tensor:
    """Copy the first ``n_rows`` rows of physical block ``src`` into block
    ``dst`` across every layer, in place — the admission-time
    copy-on-write: a partially matched cached block's reusable rows move
    into a block the new slot OWNS, and the shared source is never
    written. pool ``[L, num_blocks + 1, block_size, H, D]``."""
    bs = pool.shape[2]
    keep = (torch.arange(bs, device=pool.device)
            < torch.as_tensor(n_rows, device=pool.device))[None, :, None,
                                                            None]
    src, dst = int(src), int(dst)
    pool[:, dst] = torch.where(keep, pool[:, src], pool[:, dst])
    return pool


class BlockAllocator:
    """Host-side refcounted free-list over the physical pool. Admission
    reserves the request's worst-case block count up front (prompt +
    max_new_tokens, clamped to max_seq_len), so a decoding slot can never
    fail to grow. A block may be referenced by several holders at once —
    multiple slots aliasing a shared prefix plus the prefix index's own
    pin — and returns to the free list only when the LAST reference
    drops (``free()`` on an aliased block while a reader still holds it
    merely decrements)."""

    def __init__(self, cfg: KVCacheConfig):
        self.cfg = cfg
        self._free: List[int] = list(range(cfg.num_blocks))
        self._owned: dict = {}   # slot -> list of physical block ids
        self._refs: Dict[int, int] = {}   # block -> live reference count

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def refcount(self, block: int) -> int:
        return self._refs.get(int(block), 0)

    def refcounts(self) -> Dict[int, int]:
        """Per-block live reference counts (the /debug/state payload;
        safe to call from handler threads)."""
        return dict(_stable_items(self._refs))

    def aliased_blocks(self) -> int:
        """Blocks held by more than one reference (shared prefix)."""
        return sum(1 for _, c in _stable_items(self._refs) if c >= 2)

    def can_alloc(self, n_tokens: int) -> bool:
        return self.cfg.blocks_needed(n_tokens) <= len(self._free)

    def alloc(self, slot: int, n_tokens: int,
              shared: Sequence[int] = ()) -> np.ndarray:
        """Reserve blocks for ``n_tokens`` positions; returns the slot's
        table row ``[max_blocks_per_slot]`` (unused entries = trash).

        ``shared``: already-written physical blocks aliased as the row's
        LEADING entries (their refcount is bumped; the slot must never
        write them) — only the remainder comes off the free list."""
        shared = [int(b) for b in shared]
        need = self.cfg.blocks_needed(n_tokens) - len(shared)
        if need < 0:
            raise ValueError(
                f"{len(shared)} shared blocks exceed the "
                f"{self.cfg.blocks_needed(n_tokens)} needed for "
                f"{n_tokens} tokens")
        if need > len(self._free):
            raise RuntimeError(
                f"KV pool exhausted: need {need} blocks, "
                f"{len(self._free)} free")
        if slot in self._owned:
            raise RuntimeError(f"slot {slot} already holds blocks")
        for b in shared:
            if self._refs.get(b, 0) <= 0:
                raise RuntimeError(
                    f"block {b} aliased while unreferenced (stale "
                    "prefix-index entry?)")
            self._refs[b] += 1
        fresh = []
        for _ in range(need):
            b = self._free.pop()
            self._refs[b] = 1
            fresh.append(b)
        blocks = shared + fresh
        self._owned[slot] = blocks
        row = np.full((self.cfg.max_blocks_per_slot,),
                      self.cfg.trash_block, np.int32)
        row[:len(blocks)] = blocks
        return row

    def retain(self, block: int) -> None:
        """Extra pin on a live block (the prefix index's hold on a cached
        block: the block survives its writer slot's release)."""
        b = int(block)
        if self._refs.get(b, 0) <= 0:
            raise RuntimeError(f"retain of unreferenced block {b}")
        self._refs[b] += 1

    def release_block(self, block: int) -> bool:
        """Drop one reference; the block returns to the free list only at
        zero. Returns True when the block was actually freed."""
        b = int(block)
        n = self._refs.get(b, 0)
        if n <= 0:
            raise RuntimeError(f"block {b} over-freed")
        if n == 1:
            del self._refs[b]
            self._free.append(b)
            return True
        self._refs[b] = n - 1
        return False

    def free(self, slot: int) -> None:
        for b in self._owned.pop(slot, []):
            self.release_block(b)


class PrefixIndex:
    """Host-side shared-prefix index: prompt content → resident blocks.

    One entry per cached physical block, keyed by the EXACT
    ``(parent_block_id, tuple(block_tokens))`` pair — token equality, not
    a hash, decides a match, so a collision can never alias wrong KV.
    Only FULL blocks are indexed: prompt blocks at admit (complete after
    prefill, never rewritten — decode writes land past the prompt) and,
    under suffix caching, decode blocks at slot release (complete once
    the slot stops writing — a released slot never scatters again). The
    causal argument is the same for both origins: the KV at position p
    is a pure function of tokens 0..p, so an exact token-chain match
    aliases bit-identical KV regardless of who wrote it. Every entry
    holds one allocator reference so the cached chain outlives the slot
    that wrote it. ``last-used`` ordering is a logical tick, not wall
    time — eviction order is deterministic for a given admit sequence."""

    def __init__(self, block_size: int):
        self.block_size = int(block_size)
        # (parent_block, tokens) -> block; meta: block -> {key, parent,
        # tick, origin ("prompt" | "decode")}
        self._entries: Dict[Tuple[int, Tuple[int, ...]], int] = {}
        self._meta: Dict[int, Dict[str, Any]] = {}
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0
        self.evictions = 0
        # suffix-cache counters: matches that aliased at least one
        # decode-origin block, and the decode-origin tokens they reused
        self.suffix_hits = 0
        self.suffix_tokens_reused = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def cached_blocks(self) -> int:
        return len(self._meta)

    def match(self, ids: Sequence[int]) -> List[int]:
        """Longest indexed chain of full blocks prefixing ``ids`` →
        physical block ids, oldest first (the caller caps actual reuse at
        ``len(ids) - 1`` so the last prompt token is always prefilled and
        yields the first-token logits). Bumps the chain's recency."""
        bs = self.block_size
        self._tick += 1
        chain: List[int] = []
        parent = -1
        for i in range(len(ids) // bs):
            key = (parent, tuple(int(t) for t in ids[i * bs:(i + 1) * bs]))
            blk = self._entries.get(key)
            if blk is None:
                break
            self._meta[blk]["tick"] = self._tick
            chain.append(blk)
            parent = blk
        return chain

    def insert(self, ids: Sequence[int], row: np.ndarray, n_tokens: int,
               alloc: BlockAllocator, origin: str = "prompt") -> int:
        """Register every full block of ``ids[:n_tokens]`` (now fully
        written in the pool) under an allocator pin; blocks whose chain
        key already exists are skipped (never double-pinned — the chain
        continues through the block already indexed). ``origin`` tags
        newly indexed blocks for the suffix-cache accounting ("decode" =
        inserted at release from generated tokens). Returns the number
        of newly indexed blocks."""
        bs = self.block_size
        self._tick += 1
        parent = -1
        added = 0
        for i in range(int(n_tokens) // bs):
            key = (parent, tuple(int(t) for t in ids[i * bs:(i + 1) * bs]))
            blk = self._entries.get(key)
            if blk is None:
                blk = int(row[i])
                if blk in self._meta:
                    # same block already indexed under another key is
                    # impossible (a block is written by one slot under
                    # one content); guard anyway rather than double-pin
                    parent = blk
                    continue
                alloc.retain(blk)
                self._entries[key] = blk
                self._meta[blk] = {"key": key, "parent": parent,
                                   "tick": self._tick, "origin": origin}
                added += 1
            else:
                self._meta[blk]["tick"] = self._tick
            parent = blk
        return added

    def origin_of(self, block: int) -> str:
        """The indexed origin of a cached block ("prompt" / "decode");
        entries from before the origin tag read as "prompt"."""
        meta = self._meta.get(int(block))
        return "prompt" if meta is None else meta.get("origin", "prompt")

    def count_suffix_reuse(self, chain: Sequence[int]) -> int:
        """Decode-origin blocks in a matched chain — the blocks whose
        tokens the engine generated itself and is now NOT re-prefilling.
        Callers bump ``suffix_hits``/``suffix_tokens_reused`` from this
        at admission commit (not here: an abandoned admission must not
        count)."""
        return sum(1 for b in chain if self.origin_of(b) == "decode")

    def reclaimable(self, alloc: BlockAllocator) -> int:
        """Cached blocks only the index still references — the blocks an
        eviction sweep could actually return to the free list. Read from
        handler threads too (kv_pool_stats), so snapshot defensively."""
        return sum(1 for b, _ in _stable_items(self._meta)
                   if alloc.refcount(b) == 1)

    def _subtree(self, root: int) -> List[int]:
        out: List[int] = []
        frontier = {root}
        while frontier:
            out.extend(sorted(frontier))
            frontier = {b for b, m in self._meta.items()
                        if m["parent"] in frontier and b not in out}
        return out

    def evict(self, alloc: BlockAllocator, need_free: int,
              protect: Sequence[int] = ()) -> int:
        """Cascade-evict least-recently-used chains until the allocator
        has ``need_free`` free blocks (or nothing evictable remains).
        Evicting an entry drops the INDEX pin only — a block a reader
        slot still aliases stays resident until the reader releases.
        ``protect``: blocks the in-progress admission just matched (about
        to be aliased) — their subtrees are skipped. Returns the number
        of blocks actually freed."""
        protect_set = {int(b) for b in protect}
        skipped: set = set()
        freed = 0
        while alloc.free_blocks < need_free:
            candidates = [b for b in self._meta if b not in skipped]
            if not candidates:
                break
            victim = min(candidates,
                         key=lambda b: (self._meta[b]["tick"], b))
            sub = self._subtree(victim)
            if protect_set.intersection(sub):
                skipped.add(victim)
                continue
            for blk in sub:
                key = self._meta.pop(blk)["key"]
                del self._entries[key]
                self.evictions += 1
                if alloc.release_block(blk):
                    freed += 1
        return freed

    def debug_state(self) -> Dict[str, Any]:
        return {"entries": len(self._entries),
                "cached_blocks": len(self._meta),
                "decode_blocks": sum(
                    1 for _, m in _stable_items(self._meta)
                    if m.get("origin", "prompt") == "decode"),
                "hits": int(self.hits), "misses": int(self.misses),
                "tokens_reused": int(self.tokens_reused),
                "suffix_hits": int(self.suffix_hits),
                "suffix_tokens_reused": int(self.suffix_tokens_reused),
                "evictions": int(self.evictions)}
