"""Paged KV-cache allocator with block tables (vLLM-style).

The allocator manages logical pages and — for real-model backends — can
also own the device-side page pool (``k_pages``/``v_pages`` arrays in the
exact ``[P, page_size, KVH, hd]`` layout the chunked-paged-attention
kernel consumes, stacked across attention layers).  Sim backends skip
``init_storage`` and use the same allocator for bookkeeping only, so
cluster admission and routers read one KV-pressure signal regardless of
backend.  Admission control queries ``can_admit`` so continuous batching
never over-commits HBM.

Memory-elastic serving allocates *incrementally*: ``allocate`` claims only
the prompt's pages at admission, each decode step ``extend``\\ s the table
to the step's worst-case growth (raising :class:`OutOfPages` when the pool
is exhausted — the engine's preemption trigger) and ``trim``\\ s the unused
tail back afterwards, so a request only ever holds pages for KV it has
actually frozen.

Sharded mode (``kv_shards > 1``): the physical page pool splits into
``kv_shards`` equal blocks — shard *s* owns global pages
``[s·P/S, (s+1)·P/S)`` — and each request's table is *strictly striped*:
table slot ``j`` of a request with stripe offset ``o`` draws its page from
shard ``(o + j) % S``.  The offset is fixed at ``allocate`` time (the
shard with the most free pages; ties → lowest index) and recorded, so the
split-KV attention path can reconstruct every shard's local table on
device from the replicated global table plus the per-request offset
(``distributed.collectives.split_kv_paged_partial``).  ``extend`` keeps
striping from the table's current length, ``trim``/``free`` return each
page to its owning shard, and :class:`OutOfPages` is raised exactly when
the specific shard a slot stripes onto is empty — aggregate free pages
can be positive while a request still cannot grow.  With ``kv_shards=1``
every code path degenerates to the flat allocator bit-for-bit.

Cross-request KV reuse (two-tier, content-addressed):

* **Refcounted prefix cache** — ``register_prefix`` indexes a request's
  page-aligned prompt pages in a trie keyed by each page's token tuple
  (the dict-of-tuples form of a rolling page-hash chain; Python interns
  the hash).  A later ``lookup_prefix`` longest-prefix match lets
  ``allocate_prefix`` *attach* the cached pages to the new request's
  block table with a refcount bump instead of re-allocating, so the
  covered tokens never re-enter prefill.  When a registered page's
  refcount drops to zero it is *parked* — content retained, LRU-ordered,
  but still counted as free/reclaimable — instead of returned to the
  plain free list; allocation takes plain pages first and only then
  evicts parked pages LRU-first.  The first divergent write to a shared
  (or parked-registered) page goes through ``ensure_private``:
  copy-on-write gives the writer a fresh page *from the same shard*
  (striping invariant) and performs the copy device-side in one batched
  in-place indexed copy.  Chains record their stripe offset at registration;
  joiners adopt it, so attached tables stay strictly striped under
  ``kv_shards > 1``.

* **Host tier** — ``attach_host`` adds a :class:`HostPagePool` (host-memory
  mirror with its own free list).  LRU-evicted parked prefix pages spill
  there (batched device→host gather) instead of losing their contents,
  and ``spill_request``/``swap_in_request`` move whole preemption
  victims out and back so resumption costs a transfer, not a re-prefill.
  The swap-vs-recompute decision lives in the backends (cost model via
  ``core.latency_model``); the allocator only guarantees the mechanics
  round-trip bit-identically.

With no registrations and no host tier, every path above is inert and
the allocator behaves exactly like the plain paged allocator.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch


def _host_index(idx) -> torch.Tensor:
    """Page/slot indices as a CPU int64 tensor for host-tier indexing."""
    return torch.as_tensor(np.asarray(idx, np.int64))


class OutOfPages(Exception):
    pass


@dataclass
class PrefixNode:
    """One cached prompt page: a trie node keyed by the page's token tuple
    under its parent.  ``tier`` says where the KV bytes live — ``device``
    (``page`` indexes the device pool; parked in the allocator's per-shard
    LRU while its refcount is 0) or ``host`` (``host_slot`` indexes the
    :class:`HostPagePool` mirror).  ``base`` is the stripe offset of the
    chain this node belongs to: a node at depth ``d`` always lives on
    shard ``(base + d) % kv_shards``, so attaching a chain keeps the
    joiner's table strictly striped."""
    tokens: tuple
    depth: int
    base: int
    page: int | None = None
    tier: str = "device"
    host_slot: int | None = None
    parent: "PrefixNode | None" = None
    children: dict = field(default_factory=dict)


@dataclass
class PrefixMatch:
    """Longest-prefix lookup result: a contiguous trie chain from depth 0.

    ``covered`` counts prompt tokens served from cache.  ``partial`` means
    the final node covers only the head of its page — the joiner's prompt
    ends mid-page inside a cached page.  Partial matches are only returned
    when they complete the *whole* prompt (no further prefill possible into
    a shared page); the joiner's first decode write into that page is the
    classic copy-on-write trigger."""
    nodes: list
    covered: int
    offset: int
    page_size: int
    partial: bool = False

    @property
    def n_pages(self) -> int:
        return len(self.nodes)

    @property
    def n_device(self) -> int:
        return sum(1 for nd in self.nodes if nd.tier == "device")

    @property
    def n_host(self) -> int:
        return len(self.nodes) - self.n_device

    def device_only(self, align: int = 1):
        """Truncate at the first host-tier node (the swap-declined path),
        re-aligned down to ``align`` tokens; ``None`` when nothing
        device-resident survives."""
        nodes = []
        for nd in self.nodes:
            if nd.tier != "device":
                break
            nodes.append(nd)
        if len(nodes) == len(self.nodes):
            return self
        a = max(int(align), 1)
        keep = (len(nodes) * self.page_size // a) * a
        nodes = nodes[:keep // self.page_size]
        if not nodes:
            return None
        return PrefixMatch(nodes, len(nodes) * self.page_size, self.offset,
                           self.page_size, partial=False)


class HostPagePool:
    """Host-memory spill tier: a CPU-tensor mirror of device pages with its
    own free list (pinned when the device pool is on CUDA).  Storage is
    lazily allocated on first real spill (sim backends never materialize
    it — the pool is bookkeeping-only there, exactly like the device pool
    without ``init_storage``)."""

    def __init__(self, n_pages: int):
        self.n_pages = int(n_pages)
        self._free = list(range(self.n_pages - 1, -1, -1))
        self.k_host = None
        self.v_host = None

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def slots_in_use(self) -> int:
        return self.n_pages - len(self._free)

    def alloc_slot(self):
        return self._free.pop() if self._free else None

    def free_slot(self, slot: int):
        assert 0 <= slot < self.n_pages, slot
        self._free.append(slot)

    def ensure_storage(self, device_shape, dtype, pin: bool = False):
        if self.k_host is None:
            L, _, ps, kvh, hd = device_shape
            self.k_host = torch.zeros((L, self.n_pages, ps, kvh, hd),
                                      dtype=dtype, pin_memory=pin)
            self.v_host = torch.zeros_like(self.k_host, pin_memory=pin)


@dataclass
class SpilledRequest:
    """A preemption victim parked wholesale in the host tier: host slots in
    table-slot order, the token length covered, and the stripe offset the
    table must resume with (``swap_in_request`` re-stripes identically)."""
    slots: list
    n_tokens: int
    offset: int


@dataclass
class PagedKVAllocator:
    n_pages: int
    page_size: int = 16
    kv_shards: int = 1

    _free: list = field(init=False)          # per-shard LIFO free lists
    _tables: dict = field(default_factory=dict, init=False)   # rid → [page,...]
    _lens: dict = field(default_factory=dict, init=False)     # rid → tokens
    _stripe: dict = field(default_factory=dict, init=False)   # rid → offset
    # incrementally maintained padded block-table rows (see batch_tables):
    # a row goes dirty only when pages are actually appended/popped, so the
    # steady-state decode tick reuses cached rows instead of rebuilding
    _rows: dict = field(default_factory=dict, init=False)     # rid → int32 row
    _dirty: set = field(default_factory=set, init=False)
    _batch_memo: tuple | None = field(default=None, init=False)
    # prefix cache: refcounts for every table-attached page, the trie, the
    # page → node index, and per-shard LRU parking for ref-0 cached pages
    _refs: dict = field(default_factory=dict, init=False)     # page → count
    _cached: list = field(init=False)        # per-shard OrderedDict page→node
    _page_node: dict = field(default_factory=dict, init=False)
    _prefix_root: PrefixNode = field(init=False)
    # host tier
    host: HostPagePool | None = field(default=None, init=False)
    _spilled: dict = field(default_factory=dict, init=False)  # rid → SpilledRequest
    # pages withheld by a fault injector's OutOfPages storm (see seize_pages)
    _seized: list = field(default_factory=list, init=False)
    stats: dict = field(init=False)
    # device-side page pool (None until init_storage; sim backends never set)
    k_pages: object = field(default=None, init=False)
    v_pages: object = field(default=None, init=False)
    # the pool as blocks: one a shard (an unsharded pool's one tensor)
    _k_blocks: list = field(default_factory=list, init=False)
    _v_blocks: list = field(default_factory=list, init=False)
    # the owning ModelBackend's DispatchGraphs (None: page moves run eagerly)
    graphs: object = field(default=None, init=False)

    def __post_init__(self):
        assert self.kv_shards >= 1
        assert self.n_pages % self.kv_shards == 0, \
            (self.n_pages, self.kv_shards)
        pps = self.pages_per_shard
        self._free = [list(range((s + 1) * pps - 1, s * pps - 1, -1))
                      for s in range(self.kv_shards)]
        self._cached = [OrderedDict() for _ in range(self.kv_shards)]
        self._prefix_root = PrefixNode(tokens=(), depth=-1, base=0)
        self.stats = {"cow_copies": 0, "swap_in_pages": 0,
                      "swap_out_pages": 0, "prefix_nodes_dropped": 0,
                      "migrated_out_pages": 0, "migrated_in_pages": 0}

    def _mark_dirty(self, rid: int):
        self._dirty.add(rid)
        self._batch_memo = None

    # ------------------------------------------------------------------
    @property
    def pages_per_shard(self) -> int:
        return self.n_pages // self.kv_shards

    def shard_of(self, page: int) -> int:
        return page // self.pages_per_shard

    def _avail(self, s: int) -> int:
        """Allocatable pages on shard ``s``: plain free + parked (ref-0
        cached prefix pages are reclaimable — eviction spills or drops)."""
        return len(self._free[s]) + len(self._cached[s])

    @property
    def free_pages(self) -> int:
        return sum(self._avail(s) for s in range(self.kv_shards))

    @property
    def shard_free_pages(self) -> list[int]:
        return [self._avail(s) for s in range(self.kv_shards)]

    @property
    def pages_shared(self) -> int:
        """Physical pages currently attached to more than one table."""
        return sum(1 for r in self._refs.values() if r > 1)

    @property
    def cached_pages(self) -> int:
        """Parked (ref-0, content-retaining) device prefix pages."""
        return sum(len(c) for c in self._cached)

    def pages_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 1) // self.page_size)

    def _pick_offset(self) -> int:
        """Stripe offset for a new request: fullest shard, ties → lowest."""
        if self.kv_shards == 1:
            return 0
        best = max(self._avail(s) for s in range(self.kv_shards))
        return next(s for s in range(self.kv_shards)
                    if self._avail(s) == best)

    def _shard_counts(self, offset: int, start_slot: int, n: int) -> list[int]:
        """Pages drawn from each shard by slots [start_slot, start_slot+n)."""
        counts = [0] * self.kv_shards
        for j in range(start_slot, start_slot + n):
            counts[(offset + j) % self.kv_shards] += 1
        return counts

    def _check_feasible(self, offset: int, start_slot: int, n: int,
                        what: str, reserved=None):
        for s, c in enumerate(self._shard_counts(offset, start_slot, n)):
            have = self._avail(s) - (reserved[s] if reserved else 0)
            if c > have:
                if self.kv_shards == 1:
                    raise OutOfPages(f"{what} {n} pages, have {have}")
                raise OutOfPages(
                    f"{what} {c} pages on shard {s}, have {have} "
                    f"(free per shard: {self.shard_free_pages})")

    def can_admit(self, n_tokens: int) -> bool:
        """True iff ``allocate(rid, n_tokens)`` would succeed right now —
        striping feasibility on the offset ``allocate`` would pick, not
        just aggregate free pages."""
        need = self.pages_for(n_tokens)
        o = self._pick_offset()
        counts = self._shard_counts(o, 0, need)
        return all(c <= self._avail(s) for s, c in enumerate(counts))

    # ------------------------------------------------------------------
    # Page sourcing: plain free list first, then LRU eviction of parked
    # prefix pages (spill to the host tier when attached, drop otherwise)
    # ------------------------------------------------------------------
    def _pop_page_on(self, s: int) -> int:
        if self._free[s]:
            return self._free[s].pop()
        if self._cached[s]:
            page, node = next(iter(self._cached[s].items()))  # LRU head
            del self._cached[s][page]
            if self._page_node.get(page) is node:
                del self._page_node[page]
            node.page = None
            slot = self.host.alloc_slot() if self.host is not None else None
            if slot is not None:
                self._spill_node(node, page, slot)
            else:
                self._drop_node(node)
            return page
        raise OutOfPages(f"shard {s} exhausted "
                         f"(free per shard: {self.shard_free_pages})")

    def _deref(self, page: int):
        """Drop one reference; at zero, park registered pages (content
        retained, reclaimable) and plain-free the rest."""
        r = self._refs.get(page, 0)
        if r > 1:
            self._refs[page] = r - 1
            return
        self._refs.pop(page, None)
        node = self._page_node.get(page)
        if node is not None:
            self._cached[self.shard_of(page)][page] = node  # LRU tail
        else:
            self._free[self.shard_of(page)].append(page)

    def _spill_node(self, node: PrefixNode, page: int, slot: int):
        """Evicted-but-attached prefix page → host tier (content survives;
        a later prefix hit swaps it back via ``allocate_prefix``)."""
        if self.has_storage:
            self._pages_to_host([page], [slot])
        node.tier = "host"
        node.host_slot = slot
        self.stats["swap_out_pages"] += 1

    def _drop_node(self, node: PrefixNode):
        """Remove a node and its whole subtree from the prefix index
        (descendants are unreachable once the chain is broken).  Parked
        descendant pages return to the plain free list; host descendants
        free their slots; live-referenced descendants merely unregister
        (their pages free normally at the holders' ``_deref``)."""
        if node.parent is not None:
            node.parent.children.pop(node.tokens, None)
            node.parent = None
        stack = [node]
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            nd.children = {}
            if nd.tier == "host":
                if nd.host_slot is not None:
                    self.host.free_slot(nd.host_slot)
                    nd.host_slot = None
            elif nd.page is not None:
                page = nd.page
                if self._page_node.get(page) is nd:
                    del self._page_node[page]
                c = self._cached[self.shard_of(page)]
                if page in c:
                    del c[page]
                    self._free[self.shard_of(page)].append(page)
                nd.page = None
            self.stats["prefix_nodes_dropped"] += 1

    # ------------------------------------------------------------------
    def allocate(self, rid: int, n_tokens: int):
        assert rid not in self._tables, rid
        need = self.pages_for(n_tokens)
        o = self._pick_offset()
        self._check_feasible(o, 0, need, "need")
        table = [self._pop_page_on((o + j) % self.kv_shards)
                 for j in range(need)]
        for page in table:
            self._refs[page] = 1
        self._tables[rid] = table
        self._lens[rid] = n_tokens
        self._stripe[rid] = o
        self._mark_dirty(rid)
        return list(table)

    def extend(self, rid: int, new_len: int):
        """Grow a request's allocation to cover ``new_len`` tokens."""
        table = self._tables[rid]
        need = self.pages_for(new_len) - len(table)
        o = self._stripe[rid]
        if need > 0:
            self._check_feasible(o, len(table), need, "extend needs")
            for j in range(len(table), len(table) + need):
                page = self._pop_page_on((o + j) % self.kv_shards)
                self._refs[page] = 1
                table.append(page)
            self._mark_dirty(rid)
        self._lens[rid] = new_len
        return list(table)

    def trim(self, rid: int, new_len: int):
        """Shrink a request's allocation to cover ``new_len`` tokens,
        returning now-unused tail pages to the pool.  Never grows: a
        ``new_len`` at or above the current page count is a no-op, so the
        step protocol (extend to worst case → decode → trim to realized
        length) is safe to call unconditionally."""
        table = self._tables[rid]
        keep = self.pages_for(new_len)
        if len(table) > keep:
            while len(table) > keep:
                self._deref(table.pop())
            self._mark_dirty(rid)
        self._lens[rid] = min(self._lens[rid], max(new_len, 0))
        return list(table)

    def free(self, rid: int):
        for page in reversed(self._tables.pop(rid)):
            self._deref(page)
        self._lens.pop(rid)
        self._stripe.pop(rid)
        self._rows.pop(rid, None)
        self._dirty.discard(rid)
        self._batch_memo = None

    def block_table(self, rid: int) -> list[int]:
        return list(self._tables[rid])

    def table_len(self, rid: int) -> int:
        """Pages currently held by ``rid`` — O(1), no table copy (the
        per-step deficit scan calls this for every active request)."""
        return len(self._tables[rid])

    def length(self, rid: int) -> int:
        return self._lens[rid]

    def stripe_offset(self, rid: int) -> int:
        return self._stripe[rid]

    def stripe_offsets(self, rids) -> np.ndarray:
        """Per-request stripe offsets [B] int32 (all zeros when unsharded)
        — the device-side companion of ``batch_tables``."""
        return np.array([self._stripe[rid] for rid in rids], np.int32)

    @property
    def utilization(self) -> float:
        """Fraction of *unique physical* pages pinned (refcount > 0).
        Shared pages count once regardless of how many tables hold them,
        and parked prefix pages count as free — they are reclaimable, so
        a warm cache never chokes admission or the saturation signal."""
        return 1.0 - self.free_pages / self.n_pages

    def gauges(self) -> dict:
        """Telemetry gauge snapshot (the tracer samples this once per tick
        — the allocator deliberately emits no per-alloc/extend/trim events,
        which would swamp the ring buffer at page granularity)."""
        free = self.free_pages
        g = {"n_pages": self.n_pages, "free_pages": free,
             "pages_in_use": self.n_pages - free,
             "n_requests": len(self._tables),
             "utilization": 1.0 - free / self.n_pages,
             "pages_shared": self.pages_shared,
             "cached_prefix_pages": self.cached_pages}
        if self._seized:
            g["seized_pages"] = len(self._seized)
        if self.kv_shards > 1:
            g["kv_shards"] = self.kv_shards
            g["shard_pages_in_use"] = [
                self.pages_per_shard - self._avail(s)
                for s in range(self.kv_shards)]
        if self.host is not None:
            g["host_pages"] = self.host.n_pages
            g["host_pages_in_use"] = self.host.slots_in_use
            g["spilled_requests"] = len(self._spilled)
        return g

    # ------------------------------------------------------------------
    # Prefix cache: register / lookup / attach / copy-on-write
    # ------------------------------------------------------------------
    def register_prefix(self, rid: int, tokens, limit: int | None = None) -> int:
        """Index ``rid``'s full prompt pages in the prefix trie so later
        admissions can attach them.  Walks existing chains (first
        registrant of a page's token tuple wins); only descends chains
        whose stripe base matches ``rid``'s offset, so every registered
        node keeps the shard-(base+depth) invariant.  A host-tier node
        re-encountered with a fresh device copy is promoted back to the
        device tier for free.  Returns the number of pages newly indexed."""
        table = self._tables.get(rid)
        if not table or tokens is None:
            return 0
        ps = self.page_size
        n_tok = len(tokens) if limit is None else min(len(tokens), limit)
        o = self._stripe[rid]
        node = self._prefix_root
        new = 0
        for d in range(min(n_tok // ps, len(table))):
            key = tuple(int(t) for t in tokens[d * ps:(d + 1) * ps])
            child = node.children.get(key)
            page = table[d]
            if child is None:
                if page in self._page_node:
                    break  # page already backs a different chain
                child = PrefixNode(tokens=key, depth=d, base=o, page=page,
                                   parent=node)
                node.children[key] = child
                self._page_node[page] = child
                new += 1
            else:
                if child.base != o:
                    break  # striping-incompatible chain; don't extend it
                if child.tier == "host" and page not in self._page_node:
                    # fresh device copy of a spilled prefix: promote
                    self.host.free_slot(child.host_slot)
                    child.host_slot = None
                    child.tier = "device"
                    child.page = page
                    self._page_node[page] = child
                    new += 1
            node = child
        return new

    def lookup_prefix(self, tokens, n_tokens: int | None = None,
                      align: int = 1):
        """Longest page-chain prefix match for a prompt.  Full pages match
        exactly; a shorter-than-page tail matches the *head* of a cached
        page only when that completes the whole prompt (``partial=True``).
        Non-covering matches are truncated down to ``align`` tokens
        (diffusion backends pass lcm(page, block) so the remaining prefill
        cursor stays block-aligned).  Returns a :class:`PrefixMatch` or
        ``None``; bumps matched parked pages in the LRU."""
        if tokens is None:
            return None
        ps = self.page_size
        n_tok = len(tokens) if n_tokens is None else min(len(tokens), n_tokens)
        node = self._prefix_root
        chain = []
        d = 0
        while (d + 1) * ps <= n_tok:
            child = node.children.get(
                tuple(int(t) for t in tokens[d * ps:(d + 1) * ps]))
            if child is None:
                break
            chain.append(child)
            node = child
            d += 1
        covered = d * ps
        partial = False
        rem = n_tok - covered
        if 0 < rem < ps:
            tail = tuple(int(t) for t in tokens[covered:covered + rem])
            for key, child in node.children.items():
                if key[:rem] == tail:
                    chain.append(child)
                    covered = n_tok
                    partial = True
                    break
        if not chain:
            return None
        if not partial and align > 1:
            keep = (covered // align) * align
            chain = chain[:keep // ps]
            covered = keep
            if not chain:
                return None
        for nd in chain:  # LRU bump
            if nd.tier == "device" and self._refs.get(nd.page, 0) == 0:
                c = self._cached[self.shard_of(nd.page)]
                if nd.page in c:
                    c.move_to_end(nd.page)
        return PrefixMatch(list(chain), covered, chain[0].base, ps, partial)

    def _prefix_demand(self, n_tokens: int, match: PrefixMatch):
        """(per-shard fresh-page counts, per-shard protected-parked counts)
        for attaching ``match`` and allocating the uncovered tail."""
        o = match.offset
        need = self.pages_for(n_tokens)
        counts = self._shard_counts(o, match.n_pages, need - match.n_pages)
        parked = [0] * self.kv_shards
        for nd in match.nodes:
            if nd.tier == "host":
                counts[(o + nd.depth) % self.kv_shards] += 1
            elif self._refs.get(nd.page, 0) == 0:
                parked[self.shard_of(nd.page)] += 1
        return counts, parked

    def can_admit_prefix(self, n_tokens: int, match: PrefixMatch) -> bool:
        counts, parked = self._prefix_demand(n_tokens, match)
        return all(c <= self._avail(s) - parked[s]
                   for s, c in enumerate(counts))

    def allocate_prefix(self, rid: int, n_tokens: int, match: PrefixMatch):
        """Attach a prefix match to a new request: cached device pages are
        revived/shared (refcount bump, zero new pages), host-tier chain
        pages swap back in (batched), and only the uncovered tail draws
        fresh pages.  The request adopts the chain's stripe offset so the
        table stays strictly striped.  All-or-nothing: feasibility is
        checked before any state mutates."""
        assert rid not in self._tables, rid
        counts, parked = self._prefix_demand(n_tokens, match)
        for s, c in enumerate(counts):
            if c > self._avail(s) - parked[s]:
                raise OutOfPages(
                    f"prefix attach needs {c} pages on shard {s}, have "
                    f"{self._avail(s) - parked[s]} net of protected cache")
        o = match.offset
        # 1) revive/share every device-resident chain page first, so the
        #    fresh-page pops below can never evict them
        for nd in match.nodes:
            if nd.tier != "device":
                continue
            page = nd.page
            r = self._refs.get(page, 0)
            if r == 0:
                self._cached[self.shard_of(page)].pop(page, None)
                self._refs[page] = 1
            else:
                self._refs[page] = r + 1
        # 2) host-tier chain pages: fresh device page on the striped shard,
        #    batched host→device swap, node promoted back to device tier
        swap_slots, swap_pages = [], []
        for nd in match.nodes:
            if nd.tier != "host":
                continue
            page = self._pop_page_on((o + nd.depth) % self.kv_shards)
            self._refs[page] = 1
            swap_slots.append(nd.host_slot)
            swap_pages.append(page)
            self.host.free_slot(nd.host_slot)
            nd.host_slot = None
            nd.tier = "device"
            nd.page = page
            self._page_node[page] = nd
        if swap_pages:
            if self.has_storage:
                self._swap_in_device(swap_slots, swap_pages)
            self.stats["swap_in_pages"] += len(swap_pages)
        # 3) uncovered tail
        table = [nd.page for nd in match.nodes]
        for j in range(match.n_pages, self.pages_for(n_tokens)):
            page = self._pop_page_on((o + j) % self.kv_shards)
            self._refs[page] = 1
            table.append(page)
        self._tables[rid] = table
        self._lens[rid] = n_tokens
        self._stripe[rid] = o
        self._mark_dirty(rid)
        return list(table)

    def ensure_private(self, rid: int, lo_token: int, hi_token: int):
        """Copy-on-write trigger: make every page backing token range
        [lo_token, hi_token) privately owned by ``rid`` before a write
        lands there.  A page needs COW when it is shared (refcount > 1)
        *or* registered in the prefix index (its parked contents must
        survive the owner's divergence).  The writer gets a fresh page
        from the same shard (striping invariant); the device copy is one
        batched in-place copy (reads complete before writes, so
        chained src/dst overlaps are safe).  All-or-nothing under
        :class:`OutOfPages`.  Returns the (src, dst) pairs copied."""
        table = self._tables[rid]
        lo = max(lo_token, 0) // self.page_size
        hi = min(self.pages_for(max(hi_token, 1)), len(table))
        cows = [j for j in range(lo, hi)
                if self._refs.get(table[j], 0) > 1
                or table[j] in self._page_node]
        if not cows:
            return []
        o = self._stripe[rid]
        counts = [0] * self.kv_shards
        for j in cows:
            counts[(o + j) % self.kv_shards] += 1
        for s, c in enumerate(counts):
            if c > self._avail(s):
                raise OutOfPages(
                    f"COW needs {c} pages on shard {s}, have "
                    f"{self._avail(s)}")
        pairs = []
        for j in cows:
            src = table[j]
            dst = self._pop_page_on((o + j) % self.kv_shards)
            self._refs[dst] = 1
            self._deref(src)
            table[j] = dst
            pairs.append((src, dst))
        self._mark_dirty(rid)
        self.stats["cow_copies"] += len(pairs)
        if self.has_storage:
            self._device_copy([p for p, _ in pairs], [q for _, q in pairs])
        return pairs

    # ------------------------------------------------------------------
    # Host tier: whole-request spill / swap-in
    # ------------------------------------------------------------------
    def attach_host(self, n_pages: int):
        """Enable the host spill tier with ``n_pages`` slots."""
        if n_pages and n_pages > 0:
            self.host = HostPagePool(n_pages)
        return self.host

    def spill_request(self, rid: int):
        """Move all of ``rid``'s pages to the host tier and release the
        device pages (refcount-aware: shared prefix pages stay on device
        for their other holders — the host copy is self-contained, a
        deliberate redundancy that keeps swap-in one batched scatter).
        Returns the :class:`SpilledRequest` or ``None`` when the host
        pool cannot hold the table."""
        if self.host is None or rid in self._spilled:
            return None
        table = self._tables.get(rid)
        if table is None or self.host.free_slots < len(table):
            return None
        slots = [self.host.alloc_slot() for _ in table]
        if self.has_storage:
            self._pages_to_host(table, slots)
        self.stats["swap_out_pages"] += len(table)
        sp = SpilledRequest(slots, self._lens[rid], self._stripe[rid])
        self._spilled[rid] = sp
        for page in reversed(self._tables.pop(rid)):
            self._deref(page)
        self._lens.pop(rid)
        self._stripe.pop(rid)
        self._rows.pop(rid, None)
        self._dirty.discard(rid)
        self._batch_memo = None
        return sp

    def is_spilled(self, rid: int) -> bool:
        return rid in self._spilled

    def spilled_pages(self, rid: int) -> int:
        return len(self._spilled[rid].slots)

    def spilled_tokens(self, rid: int) -> int:
        return self._spilled[rid].n_tokens

    def can_swap_in(self, rid: int) -> bool:
        sp = self._spilled[rid]
        counts = self._shard_counts(sp.offset, 0, len(sp.slots))
        return all(c <= self._avail(s) for s, c in enumerate(counts))

    def swap_in_request(self, rid: int):
        """Re-admit a spilled request: fresh device pages on the original
        stripe offset, one batched host→device scatter, host slots freed.
        Raises :class:`OutOfPages` (state unchanged) when infeasible."""
        sp = self._spilled[rid]
        o, n = sp.offset, len(sp.slots)
        self._check_feasible(o, 0, n, "swap-in needs")
        del self._spilled[rid]
        table = []
        for j in range(n):
            page = self._pop_page_on((o + j) % self.kv_shards)
            self._refs[page] = 1
            table.append(page)
        if self.has_storage:
            self._swap_in_device(sp.slots, table)
        for slot in sp.slots:
            self.host.free_slot(slot)
        self.stats["swap_in_pages"] += n
        self._tables[rid] = table
        self._lens[rid] = sp.n_tokens
        self._stripe[rid] = o
        self._mark_dirty(rid)
        return list(table)

    def discard_spilled(self, rid: int):
        sp = self._spilled.pop(rid, None)
        if sp is not None:
            for slot in sp.slots:
                self.host.free_slot(slot)

    # ------------------------------------------------------------------
    # Cross-replica migration: a spilled request's host pages are the
    # portable representation of its KV state — export detaches them from
    # this allocator (slots freed, bytes copied out), adopt re-homes them
    # in another allocator's host tier.  Swap-in at the adopter then
    # resumes the exact trajectory.
    # ------------------------------------------------------------------
    def export_spilled(self, rid: int) -> dict | None:
        """Detach ``rid``'s spilled state into a self-contained payload
        (token length, stripe offset, and — when host storage is
        materialized — the raw KV bytes).  The local host slots are freed;
        the request no longer exists in this allocator."""
        sp = self._spilled.pop(rid, None)
        if sp is None:
            return None
        payload = {"n_tokens": sp.n_tokens, "offset": sp.offset,
                   "n_pages": len(sp.slots), "k": None, "v": None}
        if self.host.k_host is not None:
            sl = _host_index(sp.slots)
            payload["k"] = self.host.k_host[:, sl].clone()
            payload["v"] = self.host.v_host[:, sl].clone()
        for slot in sp.slots:
            self.host.free_slot(slot)
        self.stats["migrated_out_pages"] += len(sp.slots)
        return payload

    def adopt_spilled(self, rid: int, payload: dict) -> bool:
        """Re-home an exported spill payload in this allocator's host tier.
        Returns False (allocator unchanged) when there is no host tier, not
        enough free slots, ``rid`` already exists here, or the payload
        carries KV bytes this pool cannot store."""
        n = payload["n_pages"]
        if (self.host is None or rid in self._spilled
                or rid in self._tables or self.host.free_slots < n):
            return False
        if payload["k"] is not None and self.has_storage:
            self._ensure_host_storage()
        if self.host.k_host is None and payload["k"] is not None:
            # adopter has never materialized storage and has no device pool
            # to size it from — bytes would be lost, refuse the transfer
            if not self.has_storage:
                return False
        slots = [self.host.alloc_slot() for _ in range(n)]
        if payload["k"] is not None and self.host.k_host is not None:
            sl = _host_index(slots)
            self.host.k_host[:, sl] = payload["k"]
            self.host.v_host[:, sl] = payload["v"]
        self._spilled[rid] = SpilledRequest(
            slots, payload["n_tokens"], payload["offset"] % self.kv_shards)
        self.stats["migrated_in_pages"] += n
        return True

    # ------------------------------------------------------------------
    # Fault support: OutOfPages storms and crash wipes
    # ------------------------------------------------------------------
    def seize_pages(self, n: int) -> int:
        """Withhold up to ``n`` plain-free pages from allocation (an
        injected memory-pressure storm: pages vanish round-robin across
        shards, as if a co-tenant grabbed them).  Parked prefix pages are
        not touched — the storm steals *free* memory, the cache responds
        through the normal eviction path as pressure mounts.  Returns the
        number actually seized."""
        taken = 0
        while taken < n and any(self._free[s] for s in range(self.kv_shards)):
            s = max(range(self.kv_shards), key=lambda i: len(self._free[i]))
            self._seized.append(self._free[s].pop())
            taken += 1
        if taken:
            self._batch_memo = None
        return taken

    def release_seized(self) -> int:
        """Return every seized page to its shard's free list."""
        n = len(self._seized)
        for page in self._seized:
            self._free[self.shard_of(page)].append(page)
        self._seized = []
        return n

    def drop_prefix_cache(self):
        """Forget every indexed prefix: parked device pages return to the
        free lists, host-resident prefix nodes free their slots, pages
        still referenced by live tables merely unregister (they free
        normally at the holders' release).  Used on crash wipes — a dead
        replica's cache contents are gone."""
        for child in list(self._prefix_root.children.values()):
            self._drop_node(child)
        self._prefix_root = PrefixNode(tokens=(), depth=-1, base=0)

    def crash_wipe(self):
        """Simulated process death: every table, spill, and cached prefix
        page is dropped and the free lists are rebuilt full (seized pages
        included — the storm dies with the process).  Decode *state* loss
        is the backend's concern; this resets only the memory plane."""
        for rid in list(self._tables):
            self.free(rid)
        for rid in list(self._spilled):
            self.discard_spilled(rid)
        self.drop_prefix_cache()
        self.release_seized()

    # ------------------------------------------------------------------
    # Device-side page movement (COW copies, host→device swap-ins,
    # device→host spills).  All are in-place indexed copies into the pool
    # tensors on pow-2-padded index vectors (padding duplicates the last
    # pair — a duplicate identical write/copy is a no-op), so the pool's
    # storage never moves: ``k_pages.data_ptr()`` (of every shard's block)
    # is stable for the pool's life.  A sharded pool routes each global
    # page to (its shard's block, its local index).  COW copies and
    # swap-ins (the reference's donated ``_copy_jit``/``_swapin_jit``)
    # replay a CUDA graph of the owning backend's cache, one a (kind,
    # block, padded count); a pool on its own runs them eagerly.  Spills
    # stay eager, as the reference's are no jit either.
    # ------------------------------------------------------------------
    def pool_blocks(self):
        """The pool as (k blocks, v blocks, pages a block): block ``s`` holds
        global pages ``[s·per, (s+1)·per)``, one block a shard of a sharded
        pool, the one tensor of an unsharded pool."""
        return self._k_blocks, self._v_blocks, \
            self.n_pages // max(len(self._k_blocks), 1)

    def _by_block(self, pages: list):
        """Global ``pages`` grouped by the block that holds them: ``[(block,
        positions in pages, local indices), ...]`` (one group for an
        unsharded pool, whose local indices are the global ones)."""
        per = self.pool_blocks()[2]
        groups: dict[int, tuple] = {}
        for i, page in enumerate(pages):
            b, local = divmod(int(page), per)
            pos, loc = groups.setdefault(b, ([], []))
            pos.append(i)
            loc.append(local)
        return [(b, pos, loc) for b, (pos, loc) in sorted(groups.items())]

    def _pages_to_host(self, pages: list, slots: list):
        """Copy device ``pages`` into host-tier ``slots``, pairwise."""
        self._ensure_host_storage()
        ks, vs, _ = self.pool_blocks()
        for b, pos, loc in self._by_block(pages):
            idx = self._index(loc, ks[b])
            sl = _host_index([slots[i] for i in pos])
            self.host.k_host[:, sl] = ks[b][:, idx].cpu()
            self.host.v_host[:, sl] = vs[b][:, idx].cpu()

    @property
    def page_bytes(self) -> float:
        """Bytes per logical page (K + V across all attention layers)."""
        if not self.has_storage:
            return 0.0
        k = self._k_blocks[0]
        per = k.element_size()
        for i, d in enumerate(k.shape):
            if i != 1:
                per *= int(d)
        return 2.0 * per

    @staticmethod
    def _pad_pow2(idx: list) -> np.ndarray:
        m = 1
        while m < len(idx):
            m <<= 1
        return np.asarray(idx + [idx[-1]] * (m - len(idx)), np.int32)

    @staticmethod
    def _index(idx, block) -> torch.Tensor:
        return _host_index(idx).to(block.device)

    def _pool_dispatch(self, kind: str, b: int, fn, host: dict):
        """One page move ``fn(t)`` on block ``b``, ``t`` holding the arrays
        of ``host`` (index vectors padded to a power of two, host pages):
        replayed from the owning backend's graph cache (``self.graphs``,
        keyed ``(kind, b, n)``, n the padded count) when it has one, else
        run eagerly on the arrays moved to the block's device."""
        k = self._k_blocks[b]
        if self.graphs is None:
            return fn({name: a if isinstance(a, torch.Tensor)
                       else self._index(a, k) for name, a in host.items()})
        return self.graphs.dispatch((kind, b, len(host["dst"])), fn, host)

    def _device_copy(self, src: list, dst: list):
        """COW copies ``src[i] → dst[i]``; a destination is on its source's
        shard (the striping invariant), so each copy stays in one block."""
        from repro_torch.models.transformer import copy_pages
        ks, vs, per = self.pool_blocks()
        for b, pos, loc in self._by_block(dst):
            lsrc = [src[i] - b * per for i in pos]
            assert all(0 <= p < per for p in lsrc), \
                "a COW destination left its source's shard"

            def move(t, b=b):
                copy_pages({"k_pages": ks[b], "v_pages": vs[b]}, t["src"],
                           t["dst"])
                return ()

            self._pool_dispatch("copy", b, move, {
                "src": self._pad_pow2(lsrc).astype(np.int64),
                "dst": self._pad_pow2(loc).astype(np.int64)})

    def _swap_in_device(self, slots: list, pages: list):
        """Host-tier ``slots`` → device ``pages``, pairwise: the host pages
        are gathered (into pinned memory on a CUDA pool) and written whole."""
        from repro_torch.models.transformer import write_pages
        self._ensure_host_storage()
        ks, vs, _ = self.pool_blocks()
        h = self.host
        for b, pos, loc in self._by_block(pages):
            sl = _host_index(self._pad_pow2([slots[i] for i in pos]))
            k_new, v_new = (torch.index_select(t, 1, sl, out=torch.empty(
                (t.shape[0], len(sl)) + tuple(t.shape[2:]), dtype=t.dtype,
                pin_memory=t.is_pinned())) for t in (h.k_host, h.v_host))

            def move(t, b=b):
                write_pages({"k_pages": ks[b], "v_pages": vs[b]}, t["dst"],
                            t["k_new"], t["v_new"])
                return ()

            self._pool_dispatch("swap_in", b, move, {
                "dst": self._pad_pow2(loc).astype(np.int64),
                "k_new": k_new, "v_new": v_new})

    def _ensure_host_storage(self):
        k = self._k_blocks[0]
        self.host.ensure_storage(k.shape, k.dtype, pin=k.is_cuda)

    # ------------------------------------------------------------------
    # Device-side page pool (real-model backends)
    # ------------------------------------------------------------------
    def init_storage(self, n_kv_layers: int, n_kv_heads: int, head_dim: int,
                     dtype=None, *, device="cuda", shard=None):
        """Allocate the device page pool: [L_attn, P, page_size, KVH, hd].

        Each attention layer reads its own contiguous [P, page_size, KVH,
        hd] slice ``k_pages[l]`` — exactly the layout the paged attention
        kernel expects.  Every later write (decode freeze, prefill scatter,
        COW copy, swap-in) updates these two tensors in place.

        With ``shard`` (a :class:`repro_torch.distributed.collectives
        .KVShardSpec` of ``kv_shards`` shards) the pool is sharded on its
        page dim: ``k_pages``/``v_pages`` become lists of the shards' blocks
        ``[L_attn, P/S, page_size, KVH, hd]``, block ``s`` its own tensor on
        ``shard.devices[s]`` (so each layer's slice of a block is contiguous
        for the kernel), and ``device`` is unused.
        """
        dtype = torch.float32 if dtype is None else dtype
        shp = (n_kv_layers, self.n_pages, self.page_size, n_kv_heads,
               head_dim)
        if shard is None:
            self.k_pages = torch.zeros(shp, dtype=dtype, device=device)
            self.v_pages = torch.zeros(shp, dtype=dtype, device=device)
            self._k_blocks, self._v_blocks = [self.k_pages], [self.v_pages]
            return self.k_pages, self.v_pages
        if shard.n_shards != self.kv_shards:
            raise ValueError(f"{shard.n_shards} mesh shards for a pool of "
                             f"{self.kv_shards}")
        blk = (shp[0], self.pages_per_shard) + shp[2:]
        self.k_pages = [torch.zeros(blk, dtype=dtype, device=d)
                        for d in shard.devices]
        self.v_pages = [torch.zeros(blk, dtype=dtype, device=d)
                        for d in shard.devices]
        self._k_blocks, self._v_blocks = self.k_pages, self.v_pages
        return self.k_pages, self.v_pages

    @property
    def has_storage(self) -> bool:
        return self.k_pages is not None

    def batch_tables(self, rids, width: int | None = None) -> np.ndarray:
        """Padded block-table batch [B, width] int32 for a list of rids.

        Rows are padded with page index 0 (a *valid* index — the kernel
        never reads a slot past ``ctx_lens``, but every entry stays
        in-bounds all the same).  ``width`` defaults to the longest
        table in the batch.

        Incrementally maintained: each rid's padded row is cached and only
        rebuilt when its table actually changed (dirty-row tracking on
        allocate/extend/trim), and the stacked batch itself is memoized on
        the (rids, width) key — the steady-state decode tick, where tables
        grow only every ``page_size`` tokens, returns the previous array
        without touching any table.  Callers must treat the result as
        read-only (the serving backends copy it into their padded dispatch
        buffers).
        """
        if width is None:
            width = max((len(self._tables[rid]) for rid in rids), default=1)
        W = max(width, 1)
        key = (tuple(rids), W)
        if self._batch_memo is not None and self._batch_memo[0] == key:
            return self._batch_memo[1]
        rows = []
        for rid in rids:
            row = self._rows.get(rid)
            if rid in self._dirty or row is None or row.shape[0] != W:
                t = self._tables[rid]
                assert len(t) <= W, (len(t), W)
                row = np.zeros(W, np.int32)
                row[:len(t)] = t
                self._rows[rid] = row
                self._dirty.discard(rid)
            rows.append(row)
        out = np.stack(rows) if rows else np.zeros((0, W), np.int32)
        out.setflags(write=False)
        self._batch_memo = (key, out)
        return out
