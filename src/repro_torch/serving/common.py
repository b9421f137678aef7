"""Backend-agnostic serving primitives shared by the real (jit'd) and
simulated engines.

Everything here is numpy-only on purpose: the analytic-time ``SimEngine``
(serving/simengine.py) and the whole ``Cluster`` event loop import through
this module, so simulator-in-the-loop sweeps can fork worker processes
without paying the jax import (the same property ``repro.sweeps`` relies
on for the vectorized analytic path).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


class EngineFailure(RuntimeError):
    pass


class StepLog:
    """Step-time history with an optional memory bound.

    List-compatible for every access the loop and tests perform (append,
    ``len``, ``[i]``, ``[-1]``, slices, truthiness) with one extra
    guarantee: *absolute* indices stay valid after trimming, because the
    log remembers how many front entries it dropped. That preserves the
    ``n0 = len(step_times); ...; step_times[n0]`` prefill-tick contract in
    ``Cluster._step`` while a bounded engine (``step_history=N``) keeps at
    least the last N entries and at most 2N — flat memory over
    million-request fleet runs instead of one float per step forever."""

    __slots__ = ("_buf", "_off", "_cap")

    def __init__(self, cap: int = 0):
        self._buf: List[float] = []
        self._off = 0               # entries trimmed off the front
        self._cap = int(cap)

    def append(self, dt: float) -> None:
        buf = self._buf
        buf.append(dt)
        if self._cap and len(buf) > 2 * self._cap:
            drop = len(buf) - self._cap
            del buf[:drop]
            self._off += drop

    def __len__(self) -> int:
        return self._off + len(self._buf)

    def __bool__(self) -> bool:
        return bool(self._off or self._buf)

    def __iter__(self):
        return iter(self._buf)      # retained window only

    def __getitem__(self, i):
        if isinstance(i, slice):
            start, stop, step = i.indices(len(self))
            a = max(start - self._off, 0)
            b = max(stop - self._off, 0)
            return self._buf[a:b:step]
        if i < 0:
            return self._buf[i]
        j = i - self._off
        if j < 0:
            raise IndexError(f"step_times[{i}] trimmed (history cap "
                             f"{self._cap}, {self._off} dropped)")
        return self._buf[j]


class _TrieNode:
    """One chunk of cached prompt. ``keys`` holds every entry key passing
    through this node, insertion-ordered (dict-as-ordered-set: the newest
    entry through a node resolves payload lookups deterministically)."""

    __slots__ = ("children", "keys")

    def __init__(self):
        self.children: Dict[Tuple[int, ...], "_TrieNode"] = {}
        self.keys: Dict[Tuple[int, ...], None] = {}


class PrefixCache:
    """KV-cache reuse across requests sharing prompt prefixes (the paper's
    §7 "KV cache reuse" direction, cf. Mooncake/SGLang radix caching).

    Entries map a prompt-token prefix (chunk-aligned) to its KV payload; a
    new prompt resumes chunked prefill from the longest cached prefix. The
    payload is opaque — the paged real engine stores block references
    (``serving.blocks`` refcounts make sharing copy-free), the dense path
    stores jax pytrees, ``SimEngine`` stores O(1) bookkeeping records — so
    every backend shares one policy surface.

    Lookup walks a chunk-hash trie: one dict probe per ``chunk`` tokens of
    the prompt, O(len/chunk) probes total, instead of the former
    O(entries·len) linear scan. ``on_evict(payload)`` fires whenever an
    entry leaves the cache (LRU overflow or ``pop_lru``) so refcounted
    block payloads can be released exactly once."""

    def __init__(self, chunk: int, max_entries: int = 16,
                 on_evict: Optional[Callable[[Any], None]] = None):
        self.chunk = chunk
        self.max_entries = max_entries
        self.on_evict = on_evict
        self._root = _TrieNode()
        self._entries: Dict[Tuple[int, ...], Any] = {}  # key -> payload, LRU
        self.version = 0            # bumped per insert/evict (probe memo key)
        self.hits = 0
        self.hit_tokens = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def _walk(self, prompt: np.ndarray):
        """(deepest_node, usable_prefix_len): the longest chunk-aligned
        common prefix with any cached entry, clamped so at least one suffix
        chunk remains to process."""
        pt = np.asarray(prompt)
        chunk = self.chunk
        node, depth = self._root, 0
        for lo in range(0, (len(pt) // chunk) * chunk, chunk):
            child = node.children.get(tuple(int(t) for t in pt[lo:lo + chunk]))
            if child is None or not child.keys:
                break
            node, depth = child, depth + 1
        common = depth * chunk
        # need at least one suffix chunk left to process
        if common >= len(pt):
            common = len(pt) - chunk
        return (node, common) if common > 0 else (None, 0)

    def match_len(self, prompt: np.ndarray) -> int:
        """Usable cached-prefix length without touching hit/miss stats
        (scheduler affinity probes)."""
        return self._walk(prompt)[1]

    def lookup(self, prompt: np.ndarray):
        """Longest chunk-aligned common prefix with any cached entry ->
        (payload, length) or (None, 0). Positions beyond the common prefix
        in the reused cache are overwritten by the resumed chunked prefill
        and causally masked meanwhile, so partial reuse is exact. The
        payload is the newest entry through the deepest matched node (all
        candidates agree on the returned prefix)."""
        node, best_len = self._walk(prompt)
        if node is None or best_len <= 0:
            self.misses += 1
            return None, 0
        self.hits += 1
        self.hit_tokens += best_len
        key = next(reversed(node.keys))
        return self._entries[key], best_len

    def _remove(self, key: Tuple[int, ...], evict: bool):
        payload = self._entries.pop(key)
        node, chunk = self._root, self.chunk
        path = []
        for lo in range(0, len(key), chunk):
            node = node.children[key[lo:lo + chunk]]
            path.append(node)
            node.keys.pop(key, None)
        # prune emptied branches bottom-up
        for i in range(len(path) - 1, -1, -1):
            if path[i].keys or path[i].children:
                break
            parent = path[i - 1] if i else self._root
            parent.children.pop(key[(i) * chunk:(i + 1) * chunk], None)
        if evict and self.on_evict is not None:
            self.on_evict(payload)
        return payload

    def insert(self, prompt: np.ndarray, cache):
        """Record ``prompt``'s chunk-aligned prefix -> ``cache``. The key is
        trimmed to the *true* prompt length (never the padded compute
        shape), so shared prefixes carry no pad garbage."""
        n = (len(prompt) // self.chunk) * self.chunk
        if n == 0:
            return
        key = tuple(int(t) for t in prompt[:n])
        if key in self._entries:
            self._remove(key, evict=True)   # refresh recency; release the
        #   superseded payload through on_evict (block refs drop exactly once)
        self._entries[key] = cache
        node = self._root
        for lo in range(0, n, self.chunk):
            node = node.children.setdefault(key[lo:lo + self.chunk],
                                            _TrieNode())
            node.keys[key] = None
        if len(self._entries) > self.max_entries:
            self._remove(next(iter(self._entries)), evict=True)
        self.version += 1

    def pop_lru(self) -> bool:
        """Evict the least-recently-inserted entry (fires ``on_evict``);
        False when empty. The paged engine calls this to reclaim pool
        blocks under allocation pressure."""
        if not self._entries:
            return False
        self._remove(next(iter(self._entries)), evict=True)
        self.version += 1
        return True
