"""Host-side paging layer for the paged KV cache (counterpart:
``deeplearning4j_tpu/serving/paging.py``; ``models/bert.py`` owns the
device side — the block pool and the block-table prefill/decode):

- block accounting and the refcounted :class:`BlockAllocator`;
- :class:`SharedPrefix`, one registered prefix and its pinned blocks;
- :class:`PrefixCache` over :class:`RadixPrefixIndex`, the automatic
  longest-prefix cache of retired streams' full blocks;
- :class:`BlockSwapStore` of :class:`SwapEntry`, the bounded host-RAM
  parking lot of preempted streams' blocks.

Plain host bookkeeping: integers and token arrays under locks, a
deterministic LIFO free list."""
from __future__ import annotations

import dataclasses
import itertools
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.serving.admission import KVBlocksExhaustedError


def blocks_for_tokens(tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``tokens`` positions (ceil division)."""
    return -(-tokens // block_size)


def kv_bytes_per_token(layers: int, heads: int, head_dim: int,
                       kv_dtype: str = "float32",
                       itemsize: int = 4) -> int:
    """Device bytes one token position occupies in the KV cache: K and V
    at ``itemsize`` bytes per element, or for ``"int8"`` 1-byte values
    plus one fp32 scale per (token, head) per tensor."""
    if kv_dtype == "int8":
        per_head = head_dim * 1 + 4          # int8 values + f32 scale
    else:
        per_head = head_dim * itemsize
    return layers * 2 * heads * per_head     # K and V


class BlockAllocator:
    """Refcounted free-list allocator over a fixed block pool.

    Blocks ``[0, reserved)`` are never handed out — block 0 is the scratch
    block dead slots write into, so giving it to a stream would let dead
    slots corrupt live K/V. ``alloc`` is all-or-nothing, ``free`` drops
    one reference per block and returns it to the free list at zero, and
    freeing an unallocated block raises (the double-free guard)."""

    def __init__(self, num_blocks: int, reserved: int = 1):
        if num_blocks <= reserved:
            raise ValueError(
                f"num_blocks {num_blocks} must exceed the {reserved} "
                "reserved scratch block(s)")
        self.num_blocks = num_blocks
        self.reserved = reserved
        # LIFO: pop() hands back the most recently freed block first
        self._free: List[int] = list(range(num_blocks - 1, reserved - 1, -1))
        self._ref = np.zeros(num_blocks, np.int64)
        self._lock = threading.Lock()

    @property
    def capacity(self) -> int:
        """Allocatable blocks (reserved scratch excluded)."""
        return self.num_blocks - self.reserved

    @property
    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def in_use(self) -> int:
        with self._lock:
            return self.capacity - len(self._free)

    def refcount(self, block: int) -> int:
        with self._lock:
            return int(self._ref[block])

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` fresh blocks (each at refcount 1), or raise
        :class:`KVBlocksExhaustedError` leaving the allocator unchanged."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        with self._lock:
            if n > len(self._free):
                raise KVBlocksExhaustedError(
                    f"KV block pool exhausted: {n} blocks requested, "
                    f"{len(self._free)} free of {self.capacity}",
                    needed=n, usable=len(self._free),
                    capacity=self.capacity)
            out = [self._free.pop() for _ in range(n)]
            for b in out:
                self._ref[b] = 1
            return out

    def incref(self, blocks: Sequence[int]):
        """Add one reference to each allocated block (prefix sharing).
        All-or-nothing: a block that is not allocated raises before any
        count moves."""
        with self._lock:
            for b in blocks:
                if self._ref[b] <= 0:
                    raise ValueError(
                        f"incref of unallocated block {b} — a shared "
                        "prefix referenced after its blocks were freed")
            for b in blocks:
                self._ref[b] += 1

    def free(self, blocks: Sequence[int]):
        """Drop one reference per block; blocks reaching zero return to
        the free list. Freeing a block that is already free raises."""
        with self._lock:
            self._free_locked(blocks)

    def free_batch(self, block_lists: Sequence[Sequence[int]]):
        """Free several block lists under one lock acquisition — a
        preemption victim's whole footprint at once, so no concurrent
        ``alloc`` sees part of it freed. Every list is validated before
        any count moves: a block may appear in several lists (two holders
        of a shared block), but never more often than its refcount."""
        counts: Dict[int, int] = {}
        for blocks in block_lists:
            for b in blocks:
                counts[b] = counts.get(b, 0) + 1
        with self._lock:
            for b, n in counts.items():
                if self._ref[b] < n:
                    raise ValueError(
                        f"double free of block {b}: {n} refs dropped in "
                        f"one batch but refcount is {int(self._ref[b])}")
            for blocks in block_lists:
                self._free_locked(blocks, validated=True)

    def _free_locked(self, blocks: Sequence[int], validated: bool = False):
        """Caller holds ``_lock``."""
        if not validated:
            for b in blocks:
                if self._ref[b] <= 0:
                    raise ValueError(
                        f"double free of block {b}: refcount already 0")
        for b in blocks:
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._free.append(b)


@dataclasses.dataclass
class SharedPrefix:
    """One registered shared prefix: its tokens and, once the scheduler
    has prefilled it, the pinned physical blocks holding its K/V. A cache
    rebuild sets ``blocks`` back to None (the K/V went with the pool) and
    the next stream naming the prefix re-prefills it from the tokens."""

    prefix_id: str
    tokens: np.ndarray                 # (n,) int32
    blocks: Optional[List[int]] = None
    hits: int = 0

    @property
    def length(self) -> int:
        return int(self.tokens.size)

    @property
    def ready(self) -> bool:
        return self.blocks is not None


@dataclasses.dataclass(eq=False)
class _CacheEntry:
    """One retired stream's reusable prefix: its full blocks and the
    tokens whose K/V they hold; the entry owns one allocator reference per
    block. ``tick`` is the LRU stamp (bumped on insert and on every hit);
    among entries with the longest match the smallest tick wins."""

    tokens: np.ndarray                 # (m * block_size,) int32
    blocks: List[int]                  # m physical block ids, in order
    tick: int = 0


class _RadixNode:
    """A node of :class:`RadixPrefixIndex`: ``label`` is the compressed
    edge into it, ``values`` every value registered at or below it."""

    __slots__ = ("label", "children", "values")

    def __init__(self, label: Tuple = ()):
        self.label: Tuple = tuple(label)
        self.children: Dict[object, "_RadixNode"] = {}
        self.values: set = set()


class RadixPrefixIndex:
    """Compressed radix tree over block-granular key paths (one hashable
    key per block of tokens). :meth:`match` walks it once and returns the
    longest shared depth with every value achieving it, so the caller
    keeps its own tie-break. Inserting a path that diverges inside an edge
    splits the edge; removing the last value below a node prunes it. Not
    thread-safe alone: its owner serializes access."""

    def __init__(self):
        self._root = _RadixNode()

    @staticmethod
    def _common_len(a: Sequence, b: Sequence) -> int:
        n = min(len(a), len(b))
        m = 0
        while m < n and a[m] == b[m]:
            m += 1
        return m

    def insert(self, path: Sequence, value) -> None:
        """Register ``value`` along ``path`` (a non-empty sequence of
        hashable keys), splitting edges at any divergence."""
        path = tuple(path)
        node = self._root
        i = 0
        while i < len(path):
            child = node.children.get(path[i])
            if child is None:
                child = _RadixNode(path[i:])
                node.children[path[i]] = child
                child.values.add(value)
                return
            common = self._common_len(child.label, path[i:])
            if common < len(child.label):
                # the shared run of the edge becomes its own node
                mid = _RadixNode(child.label[:common])
                mid.children[child.label[common]] = child
                mid.values = set(child.values)
                child.label = child.label[common:]
                node.children[path[i]] = mid
                child = mid
            child.values.add(value)
            node = child
            i += common

    def remove(self, path: Sequence, value) -> None:
        """Drop ``value`` from every node along ``path``, pruning nodes
        left without values. Unknown paths and values are ignored."""
        path = tuple(path)
        node = self._root
        walk = []
        i = 0
        while i < len(path):
            child = node.children.get(path[i])
            if child is None or i + len(child.label) > len(path):
                return
            walk.append((node, path[i], child))
            i += len(child.label)
            node = child
        for parent, head, child in reversed(walk):
            child.values.discard(value)
            if not child.values:
                del parent.children[head]

    def match(self, path: Sequence) -> Tuple[int, set]:
        """``(depth, values)``: the most leading keys of ``path`` any
        registered value shares, and every value sharing that many; or
        ``(0, set())``."""
        path = tuple(path)
        node = self._root
        best_depth, best_values = 0, set()
        i = 0
        while i < len(path):
            child = node.children.get(path[i])
            if child is None:
                break
            common = self._common_len(child.label, path[i:])
            if common > 0:
                best_depth, best_values = i + common, child.values
            if common < len(child.label):
                break
            node = child
            i += common
        return best_depth, set(best_values)

    def node_count(self) -> int:
        """Nodes below the root."""
        n = 0
        stack = [self._root]
        while stack:
            nd = stack.pop()
            n += len(nd.children)
            stack.extend(nd.children.values())
        return n


class PrefixCache:
    """Automatic longest-token-prefix cache over retired streams' full KV
    blocks (SGLang RadixAttention's policy on the block pool): a retiring
    stream's fully written blocks are kept instead of freed, and a later
    prompt starting with the same tokens references them and skips that
    much prefill. No opt-in: a shared system prompt hits by itself.

    Matching is block-granular (a partial tail block would be written by
    the new stream). Entries are a bounded LRU by total blocks
    (``capacity_blocks``); eviction drops the entry's references through
    the same allocator refcounts every holder uses, so a block a live
    stream also holds frees only when that stream lets go. Nothing here is
    pinned: cached blocks never gate admission.

    Every operation runs under the cache's lock. :meth:`match_and_ref`
    takes the caller's references with the match, so a release or
    eviction right after cannot free the matched blocks under the seat."""

    def __init__(self, allocator: BlockAllocator, block_size: int,
                 capacity_blocks: int):
        if capacity_blocks <= 0:
            raise ValueError(
                f"capacity_blocks must be positive, got {capacity_blocks}")
        self.allocator = allocator
        self.block_size = block_size
        self.capacity_blocks = capacity_blocks
        self._entries: List[_CacheEntry] = []   # LRU order: [0] is oldest
        self._index = RadixPrefixIndex()
        self._ticks = itertools.count(1)
        self._lock = threading.Lock()
        self.hits = 0
        self.inserts = 0
        self.evictions = 0

    @property
    def total_blocks(self) -> int:
        with self._lock:
            return sum(len(e.blocks) for e in self._entries)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def insert(self, tokens: np.ndarray, blocks: Sequence[int]) -> bool:
        """Offer a retired stream's leading blocks and the tokens they
        hold (``len(tokens) == len(blocks) * block_size``). The caller
        hands over one reference per block; on rejection (an entry that
        already covers these tokens, or one larger than the whole cache)
        they are freed here. True when the entry was kept."""
        B = self.block_size
        blocks = list(blocks)
        if not blocks or len(tokens) != len(blocks) * B:
            if blocks:
                self.allocator.free(blocks)
            return False
        if len(blocks) > self.capacity_blocks:
            self.allocator.free(blocks)
            return False
        with self._lock:
            path = self._block_path(tokens, len(blocks))
            depth, covering = self._index.match(path)
            if depth == len(blocks) and covering:
                # an older entry holds at least these blocks: keep it
                self.allocator.free(blocks)
                return False
            entry = _CacheEntry(
                tokens=np.ascontiguousarray(tokens, dtype=np.int32),
                blocks=blocks, tick=next(self._ticks))
            self._entries.append(entry)
            self._index.insert(path, entry)
            self.inserts += 1
            over = sum(len(e.blocks) for e in self._entries) \
                - self.capacity_blocks
            if over > 0:
                self._evict_locked(over, protect=entry)
        return True

    def match(self, tokens: np.ndarray
              ) -> Optional[Tuple[_CacheEntry, int]]:
        """``(entry, m)``: the longest block-aligned prefix of ``tokens``
        any entry holds, m >= 1 blocks, or None. At most
        ``(len(tokens) - 1) // block_size`` blocks match: the stream keeps
        at least one token to feed. The entry moves to MRU."""
        with self._lock:
            hit = self._match_locked(tokens)
            return None if hit is None else (hit[0], hit[1])

    def match_and_ref(self, tokens: np.ndarray
                      ) -> Optional[Tuple[_CacheEntry, int, List[int]]]:
        """:meth:`match` plus one allocator reference per matched block,
        taken under the cache lock: ``(entry, m, blocks)`` with ``blocks``
        the caller's to free or seat."""
        with self._lock:
            hit = self._match_locked(tokens)
            if hit is None:
                return None
            e, m = hit
            blocks = list(e.blocks[:m])
            self.allocator.incref(blocks)
            return e, m, blocks

    def _match_locked(self, tokens: np.ndarray):
        toks = np.asarray(tokens)
        max_m = (int(toks.size) - 1) // self.block_size
        if max_m <= 0:
            return None
        m, cands = self._index.match(self._block_path(toks, max_m))
        if m <= 0 or not cands:
            return None
        e = min(cands, key=lambda c: c.tick)
        self._entries.remove(e)
        self._entries.append(e)        # MRU
        e.tick = next(self._ticks)
        self.hits += 1
        return e, m

    def _block_path(self, tokens: np.ndarray, m: int) -> Tuple[bytes, ...]:
        """The first ``m`` blocks of ``tokens`` as radix keys (each
        block's int32 bytes)."""
        toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
        B = self.block_size
        return tuple(toks[k * B:(k + 1) * B].tobytes() for k in range(m))

    def evict(self, need_blocks: int,
              protect: Optional[_CacheEntry] = None) -> int:
        """Drop LRU entries (never ``protect``) until ``need_blocks``
        references were released or the cache is empty; returns the
        references released (a block other holders keep stays off the
        free list, so callers re-read the allocator's ``free_count``)."""
        with self._lock:
            return self._evict_locked(need_blocks, protect)

    def _evict_locked(self, need_blocks: int,
                      protect: Optional[_CacheEntry] = None) -> int:
        released = 0
        i = 0
        while released < need_blocks and i < len(self._entries):
            e = self._entries[i]
            if e is protect:
                i += 1
                continue
            self._entries.pop(i)
            self._index.remove(self._block_path(e.tokens, len(e.blocks)),
                               e)
            self.allocator.free(e.blocks)
            released += len(e.blocks)
            self.evictions += 1
        return released

    def release_all(self):
        """Free every entry's references (drain, or warmup dropping its
        probes' entries)."""
        with self._lock:
            for e in self._entries:
                self.allocator.free(e.blocks)
            self._entries = []
            self._index = RadixPrefixIndex()

    def invalidate(self):
        """Drop every entry without freeing: the pool and its allocator
        were rebuilt, and the old references are void."""
        with self._lock:
            self._entries = []
            self._index = RadixPrefixIndex()

    def advertised_prefixes(self, max_entries: int = 32
                            ) -> Tuple[Tuple[int, ...], ...]:
        """The most recently used entries' token sequences as plain int
        tuples, MRU first and at most ``max_entries`` — what a host
        advertises in its heartbeat (``HostStatus.prefix_tokens``)."""
        with self._lock:
            ents = self._entries[-max_entries:] if max_entries else []
            return tuple(tuple(int(t) for t in e.tokens)
                         for e in reversed(ents))


@dataclasses.dataclass
class SwapEntry:
    """One preempted stream's parked KV state in host memory. ``payload``
    mirrors the pool's per-layer leaves — a list of ``{"k", "v"[,
    "k_scale", "v_scale"]}`` dicts of CPU tensors whose leading axis is
    the victim's used blocks — so swap-in is a row scatter into whatever
    blocks the re-seat allocates. The slot state (``length``,
    ``n_generated``, ``last_token``, ``prefix_len``) rides along: the
    re-seated stream resumes mid-decode with no prefill. The same entry
    carries a stream's pages from a prefill-class host to a decode-class
    one (``GenerationEngine.import_pages``); it names no epoch, because a
    watchdog restart drops every parked entry at once."""

    payload: List[Dict[str, object]]
    used_blocks: int
    length: int
    n_generated: int
    last_token: int
    prefix_len: int
    nbytes: int


class BlockSwapStore:
    """Bounded host-RAM parking lot for preempted streams' KV blocks (the
    swap half of vLLM's swap-vs-recompute, SOSP'23 §4.5). A victim above
    the engine's ``swap_threshold_blocks`` has its used blocks copied here
    instead of dropped, and its re-seat copies them back: one block copy
    instead of a recompute prefill. Only an optimization: every parked
    stream also carries its recompute state, so an entry evicted (LRU,
    ``capacity_blocks`` bound), discarded or invalidated sends its stream
    to recompute, never to a shed. Methods lock internally."""

    def __init__(self, capacity_blocks: int):
        if capacity_blocks <= 0:
            raise ValueError(
                f"capacity_blocks must be positive, got {capacity_blocks}")
        self.capacity_blocks = int(capacity_blocks)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[int, SwapEntry]" = OrderedDict()
        self._keys = itertools.count(1)
        self.swap_outs = 0
        self.swap_ins = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def blocks_held(self) -> int:
        with self._lock:
            return sum(e.used_blocks for e in self._entries.values())

    @property
    def bytes_held(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values())

    def put(self, entry: SwapEntry) -> Optional[int]:
        """Park one entry and return its key, or None when it alone
        exceeds the capacity; evicts the least recently parked entries
        until it fits."""
        if entry.used_blocks > self.capacity_blocks:
            return None
        with self._lock:
            held = sum(e.used_blocks for e in self._entries.values())
            while held + entry.used_blocks > self.capacity_blocks \
                    and self._entries:
                _, old = self._entries.popitem(last=False)
                held -= old.used_blocks
                self.evictions += 1
            key = next(self._keys)
            self._entries[key] = entry
            self.swap_outs += 1
            return key

    def take(self, key: Optional[int]) -> Optional[SwapEntry]:
        """Pop the entry parked under ``key``; None for a miss."""
        if key is None:
            return None
        with self._lock:
            e = self._entries.pop(key, None)
            if e is not None:
                self.swap_ins += 1
            return e

    def discard(self, key: Optional[int]) -> None:
        """Drop one entry without counting a swap-in."""
        if key is None:
            return
        with self._lock:
            self._entries.pop(key, None)

    def invalidate(self):
        """Drop every entry (the pool it was copied from was rebuilt)."""
        with self._lock:
            self._entries.clear()
