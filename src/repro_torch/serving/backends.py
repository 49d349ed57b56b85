"""Execution backends for the serving engine.

* :class:`SimBackend` — virtual-clock backend: commits come from the
  calibrated :class:`CommitSimulator`, latency from the analytic roofline
  device model.  This reproduces the paper's serving-scale experiments
  deterministically on CPU.
* :class:`ModelBackend` — real-model backend: a PyTorch model runs
  end-to-end on its device (CUDA by default); commits come from actual
  softmax confidences.  The attention-only families (dense, moe, vlm)
  serve through the unified paged KV pool and the hand-written CUDA
  chunked-paged-attention kernel (its plain version on CPU tensors); the
  recurrent families (ssm, hybrid) keep a fixed-slot cache, because their
  recurrent states cannot be paged.

Both expose the same protocol:
    can_admit(request)        -> bool
    admit(request)            -> prefill latency (s)
    decode_step(rids, chunk)  -> (latency_s, {rid: StepInfo})
    release(rid)
    state(rid)                -> decode state (ChunkedDecodeState or ARState)

Memory elasticity (Fan et al.'s admission, ROADMAP): page-backed backends
admit on **prompt pages only** and grow incrementally — every decode step
reserves its worst-case page growth up front (``step_page_deficit`` lets
the engine preempt a victim *before* the step when the pool is short), and
:class:`~repro_torch.serving.kv_pool.OutOfPages` raised from ``decode_step`` is
transactional: no decode state was mutated, so the engine can preempt and
retry the step.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.chunked import (ChunkedDecodeState, batch_apply_step,
                                batch_windows, freeze_run)
from repro_torch.core.diffusion import softmax_confidence
from repro_torch.core.latency_model import (CPU_HOST, DEVICES, TPU_V5E,
                                            AnalyticDeviceModel, DeviceSpec,
                                            kv_bytes_per_token, swap_cost_s)
from repro_torch.distributed.collectives import KVShardSpec
from repro_torch.launch.mesh import make_kv_mesh
from repro_torch.models.common import ArchConfig
from repro_torch.serving.graphs import DispatchGraphs
from repro_torch.serving.kv_pool import OutOfPages, PagedKVAllocator
from repro_torch.serving.request import Request
from repro_torch.serving.telemetry import NULL_TRACER
from repro_torch.serving.workload import CommitSimulator


# a card's name (``torch.cuda.get_device_name``) → its roofline in DEVICES;
# only the variants the specs describe (an H100 PCIe or NVL, or a 40 GB
# A100, has other peaks, so it keeps the CPU_HOST sizing)
_CARD_SPECS = (("H100 80GB HBM3", "h100-sxm"), ("A100-SXM4-80GB", "a100-80g"))
_UNKNOWN_CARDS: set = set()


def _card_spec(device: torch.device) -> DeviceSpec | None:
    """The roofline of the card ``device`` is, found by its name; None for
    the CPU, and for a card not in ``_CARD_SPECS`` (logged once a name)."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for family, spec in _CARD_SPECS:
        if family in name:
            return DEVICES[spec]
    if name not in _UNKNOWN_CARDS:
        _UNKNOWN_CARDS.add(name)
        logging.getLogger(__name__).warning(
            "no roofline for the card %r: chunked prefill keeps the "
            "CPU_HOST sizing", name)
    return None


def _slot_tensors(cache) -> list:
    """The slot cache's tensors: every recurrent state, then ``k``, ``v``
    and ``len`` where present."""
    return [t for st in cache.get("states", {}).values()
            for t in st.values()] + \
        [cache[n] for n in ("k", "v", "len") if n in cache]


@dataclass
class StepInfo:
    n_committed: int
    commit_mask: np.ndarray
    valid_len: int
    done: bool


@dataclass
class ARState:
    """Autoregressive decode bookkeeping (TU = 100% by construction)."""
    prompt_len: int
    max_new_tokens: int
    eos_token: int | None = None
    committed: np.ndarray = field(init=False)
    frozen: int = 0                 # == tokens generated
    steps: int = 0
    computed_tokens: int = 0
    gen_limit: int = field(init=False)
    committed_history: list = field(default_factory=list)

    def __post_init__(self):
        self.committed = np.full(self.max_new_tokens, -1, np.int64)
        self.gen_limit = self.max_new_tokens

    @property
    def n_committed(self):
        return int((self.committed[:self.gen_limit] != -1).sum())

    @property
    def done(self):
        return bool((self.committed[:self.gen_limit] != -1).all())

    @property
    def output_tokens(self):
        return [int(t) for t in self.committed[:self.gen_limit]]

    @property
    def token_utilization(self):
        return 1.0

    def commit(self, tok: int):
        pos = self.frozen
        self.committed[pos] = tok
        if self.eos_token is not None and tok == self.eos_token:
            self.gen_limit = min(self.gen_limit, pos + 1)
        self.frozen += 1
        self.steps += 1
        self.computed_tokens += 1
        self.committed_history.append(1)


def _decode_mode_for(cfg: ArchConfig, decode_mode: str) -> str:
    if decode_mode == "ar" or not cfg.diffusion or cfg.family == "ssm":
        return "ar"
    if cfg.family == "hybrid":
        return "block_pinned"
    return "slide"


# ===========================================================================
# Chunked-prefill scheduling (shared by sim and model backends)
# ===========================================================================

class PrefillScheduler:
    """FCFS token-budget planner over per-request prefill cursors.

    Admission claims a request's prompt pages up front but defers the
    prefill *compute*; each engine tick ``plan()`` hands out at most
    ``budget`` prompt tokens across the queue in arrival order, so a bursty
    admission wave of long prompts can no longer stall in-flight decodes
    for the whole wave's prefill latency (the head-of-line blocking the
    monolithic ``prefill_mode="wave"`` forward exhibits).

    Chunk ends are aligned to ``align`` absolute positions — a page
    boundary, raised to lcm(page, block) for diffusion models, where a
    mid-block split would hide a block's unprefilled tail from its own
    head and diverge from the wave forward — except a prompt's final
    chunk.  The budget is clamped to at least ``align`` so alignment can
    never stall the queue head: the head request always receives tokens
    every tick (no starvation), and later requests only wait on FCFS
    order.

    Budget sizing: with an explicit ``budget`` the per-tick token cap is
    fixed (the legacy ``--prefill-budget`` mode).  With ``budget=None``
    and a ``target_bc``, sizing is adaptive (Sarathi-style): each tick
    hands out ``target_bc − b·c`` prompt tokens — filling the fused
    dispatch up to the device's compute-saturation workload net of the
    tick's live decode tokens — so prefill rides the dispatch for free
    below saturation instead of being throttled by a one-size constant
    (the fixed default cost 0.55–0.68× prompt throughput past
    saturation).  Cached prefix tokens never enter the budget at all:
    ``add`` starts the cursor past them.

    Padded shape: a plan runs as one ``[bucket(B), bucket(max n)]``
    dispatch (:meth:`padded`, both powers of two).  With ``max_rows`` set,
    the token axis pads to at least one aligned chunk, and ``plan`` stops
    adding requests where the shape's rows would pass ``max_rows``: the
    plans then take a small, known set of shapes (:meth:`shapes`), and
    the queue head always gets its chunk.  ``max_rows=None`` (the
    default) bounds nothing.
    """

    def __init__(self, budget: int | None, align: int,
                 target_bc: int | None = None, max_rows: int | None = None):
        self.align = max(1, int(align))
        self.fixed = budget is not None
        self.budget = max(int(budget), self.align) if budget is not None \
            else 4 * self.align
        self.target_bc = int(target_bc) if target_bc is not None else None
        self.max_rows = max_rows
        # the token axis's least padded length
        self.min_tokens = self.align if max_rows is not None else 1
        self.queue: list[Request] = []        # FCFS over admissions
        self.cursor: dict[int, int] = {}      # rid → prompt tokens prefilled

    def padded(self, batch: int, max_n: int) -> tuple[int, int]:
        """The dispatch shape ``(Bp, Tp)`` of a plan of ``batch`` chunks
        whose longest is ``max_n`` tokens."""
        return _pow2(batch), _pow2(max(max_n, self.min_tokens))

    def shapes(self, max_tokens: int,
               rows: int | None = None) -> list[tuple[int, int]]:
        """Every ``(Bp, Tp)`` a ``max_rows``-bounded plan can take whose
        chunks are at most ``max_tokens`` long, of at most ``rows`` padded
        rows (default ``max_rows``)."""
        rows = self.max_rows if rows is None else min(rows, self.max_rows)
        out, tp = [], _pow2(self.min_tokens)
        while tp <= min(_pow2(max(max_tokens, self.min_tokens)), rows):
            bp = 1
            while bp * tp <= rows:
                out.append((bp, tp))
                bp *= 2
            tp *= 2
        return out

    def add(self, req: Request, start: int = 0) -> bool:
        """Queue a request's prefill from ``start`` (tokens a prefix-cache
        hit already covers skip the budget entirely).  Returns True when
        the prompt is already fully covered — nothing is queued and the
        request can decode immediately."""
        if start >= req.prompt_len:
            return True
        self.queue.append(req)
        self.cursor[req.rid] = int(start)
        return False

    def tick_budget(self, live_bc: int = 0) -> int:
        """Prompt tokens this tick may hand out.  Fixed mode returns the
        constructor budget; adaptive mode returns ``target_bc − live_bc``
        clamped to at least one aligned chunk (the queue head always
        advances, so alignment can never starve it)."""
        if self.fixed or self.target_bc is None:
            return self.budget
        return max(self.align, self.target_bc - max(int(live_bc), 0))

    def remove(self, rid: int):
        """Drop a request (release / preemption): the cursor is discarded —
        its pages are freed with it, so re-admission restarts at 0."""
        if rid in self.cursor:
            self.queue = [r for r in self.queue if r.rid != rid]
            del self.cursor[rid]

    def pending(self, rid: int) -> bool:
        return rid in self.cursor

    @property
    def backlog(self) -> int:
        return sum(r.prompt_len - self.cursor[r.rid] for r in self.queue)

    def plan(self, live_bc: int = 0) -> list[tuple[Request, int, int]]:
        """This tick's chunk assignments [(req, offset, n_tokens)]:
        Σ n_tokens ≤ tick_budget(live_bc), FCFS, ends aligned except
        final chunks, padded rows ≤ ``max_rows`` past the queue head."""
        out, left, max_n = [], self.tick_budget(live_bc), 0
        for req in self.queue:
            if left <= 0:
                break
            off = self.cursor[req.rid]
            end = min(off + left, req.prompt_len)
            if end < req.prompt_len:
                aligned = (end // self.align) * self.align
                if aligned <= off:      # leftover budget < one aligned chunk
                    break
                end = aligned
            if out and self.max_rows is not None:
                bp, tp = self.padded(len(out) + 1, max(max_n, end - off))
                if bp * tp > self.max_rows:
                    break
            out.append((req, off, end - off))
            left -= end - off
            max_n = max(max_n, end - off)
        return out

    def advance(self, rid: int, n: int) -> bool:
        """Move a cursor forward; True when the prompt is fully prefilled
        (the request leaves the queue)."""
        req = next(r for r in self.queue if r.rid == rid)
        self.cursor[rid] += n
        if self.cursor[rid] >= req.prompt_len:
            self.remove(rid)
            return True
        return False


def _pow2(n: int) -> int:
    """Next power of two ≥ n — bounds the distinct dispatch shapes."""
    b = 1
    while b < n:
        b *= 2
    return b


# The chunked-prefill shapes a backend on a known card captures at
# construction have at most this many padded rows (all of SDAR-8B's on
# the H100); larger ones are captured on first use.  The graph pool grows
# with the largest shape captured: on the H100 0.33 GB for SDAR-8B's 512
# rows, 6.1 GB for Scout-8L's 4,096 and 10 GB for smollm-135m's 8,192 at
# max_len 4,096, the last two paid at construction though a plan reaches
# them only with that many prompt tokens queued.
SETUP_PREFILL_ROWS = 512


def own_prefill_budget(analytic: AnalyticDeviceModel, align: int) -> int:
    """The prompt tokens a prefill dispatch of its own takes a tick: its
    saturation point on ``analytic``'s device, aligned down to ``align``
    and clamped to [align, 8192]."""
    chunks = int(analytic.saturation_ew() // align)
    return min(max(chunks, 1), 8192 // align) * align


def _prefill_align(page_size: int, cfg: ArchConfig) -> int:
    """Chunk-boundary alignment: page-sized, raised to lcm(page, block) for
    diffusion models (block-causal prefill must not split a block)."""
    if not cfg.diffusion:
        return page_size
    import math
    return page_size * cfg.block_size // math.gcd(page_size, cfg.block_size)


# ===========================================================================
# Incremental page-growth step protocol (shared by sim and model backends)
# ===========================================================================

def _worst_step_len(st, chunk: int) -> int:
    """Upper bound on a request's frozen-KV token length after one decode
    step at ``chunk`` — the page reservation the step protocol claims up
    front.  AR freezes at most one token per step; slide windows at most
    ``chunk``; block-pinned windows commit whole blocks atomically."""
    if st.done:
        return st.prompt_len + st.frozen
    if isinstance(st, ARState):
        return st.prompt_len + st.frozen + 1
    grow = st.block_size if st.mode == "block_pinned" else chunk
    return st.prompt_len + min(st.frozen + grow, st.gen_limit)


def _step_page_deficit(kv: PagedKVAllocator, states, rids, chunk: int) -> int:
    """Pages the pool is short of for the batch's worst-case step growth.
    ``<= 0`` means the next step is guaranteed to fit; positive is the
    number of pages the engine must free (by preempting) before stepping.

    Sharded pool: a request's growth slots stripe onto specific shards
    ((offset + slot) % S), so the binding constraint is the worst *shard*
    deficit, not the aggregate — freeing a victim returns its pages striped
    ≈ evenly, so the worst shard's shortfall scales by S to a
    pages-to-free figure."""
    if kv.kv_shards == 1:
        need = 0
        for rid in rids:
            st = states[rid]
            need += max(0, kv.pages_for(_worst_step_len(st, chunk))
                        - kv.table_len(rid))
        return need - kv.free_pages
    S = kv.kv_shards
    need = [0] * S
    for rid in rids:
        st = states[rid]
        t = kv.table_len(rid)
        grow = kv.pages_for(_worst_step_len(st, chunk)) - t
        o = kv.stripe_offset(rid)
        for j in range(max(0, grow)):
            need[(o + t + j) % S] += 1
    free = kv.shard_free_pages
    worst = max(n - f for n, f in zip(need, free))
    agg = sum(need) - sum(free)
    return max(agg, worst * S) if worst > 0 else agg


def _split_kv_collective_bytes(kv_shards: int, n_attn_layers: int,
                               n_heads: int, head_dim: int,
                               batch: int, tokens: int) -> int:
    """Analytic cross-shard traffic of ONE split-KV fused dispatch.

    Per attention layer the flash partials all-reduce over the kv axis:
    payload ``B·t·H·(D+2)`` fp32 (acc [B,t,H,D] psum + m [B,t,H] pmax +
    l [B,t,H] psum), at the ring all-reduce cost of ``2·(S−1)`` payload
    transfers across the axis per reduction.  The serving telemetry counter
    tracks this model (interpret-mode CPU meshes don't move real bytes)."""
    if kv_shards <= 1:
        return 0
    payload = batch * tokens * n_heads * (head_dim + 2) * 4
    return n_attn_layers * payload * 2 * (kv_shards - 1)


def _reserve_step(kv: PagedKVAllocator, states, rids, chunk: int):
    """Extend every request's table to its worst-case post-step length.

    Transactional: on :class:`OutOfPages` every partial extension is rolled
    back before re-raising, so the caller observes either a fully reserved
    step or an untouched allocator (and unmutated decode states — callers
    reserve *before* running the step)."""
    prev = []
    try:
        for rid in rids:
            prev.append((rid, kv.length(rid)))
            kv.extend(rid, max(kv.length(rid),
                               _worst_step_len(states[rid], chunk)))
    except OutOfPages:
        for rid, ln in prev:
            kv.trim(rid, ln)
        raise


def _trim_step(kv: PagedKVAllocator, states, rids):
    """Return over-reserved tail pages after a step: each request keeps
    exactly the pages covering its realized ``prompt + frozen`` KV."""
    for rid in rids:
        st = states[rid]
        kv.trim(rid, st.prompt_len + st.frozen)


# ===========================================================================
# Virtual-clock simulation backend
# ===========================================================================

class SimBackend:
    """Virtual-clock serving backend over the analytic device model.

    ``kv_admission="incremental"`` (default) admits on prompt pages only and
    grows per-step (preemption-on-OutOfPages semantics); ``"reserve"`` keeps
    the legacy worst-case ``prompt + max_new_tokens`` reservation at admit —
    the static-admission baseline the kv_pressure benchmark compares
    against.

    ``prefill_mode="chunked"`` defers prefill *latency* into the decode
    loop: admission claims prompt pages and returns immediately, and each
    decode tick charges at most ``prefill_token_budget`` prompt tokens of
    prefill alongside the decode dispatch (requests join decode the tick
    their last chunk lands).  ``"wave"`` (default, the historical sim
    behavior) charges the whole prompt's latency synchronously at
    admission — an admission wave stalls every in-flight decode for its
    full prefill span.  With ``include_prefill=False`` prefill is free and
    the modes coincide.

    Commit randomness is drawn from **per-request streams** (seeded by
    ``(seed, rid)``), so a request's simulated trajectory depends only on
    the sequence of window sizes it is stepped with, never on batch
    composition: under a fixed chunk schedule, wave and chunked prefill
    commit bit-identical tokens, and a preempted request replays its exact
    output after re-admission — the same two invariants the real-model
    backend's deterministic argmax decode has.  (An elastic scheduler may
    pick different chunks under the two prefill modes — the prefill
    signal changes its saturation estimate — which legitimately changes
    the per-request window sequence and hence its tokens, on either
    backend.)"""

    def __init__(self, cfg: ArchConfig, device: DeviceSpec = TPU_V5E,
                 n_chips: int = 1, tokens_per_step: float = 3.8,
                 gamma: float = 0.95, decode_mode: str = "elastic",
                 kv_pool_pages: int = 1 << 16, page_size: int = 16,
                 obs: bool = False, obs_policy: str = "large_chunk",
                 seed: int = 0, include_prefill: bool = True,
                 kv_admission: str = "incremental",
                 prefill_mode: str = "wave",
                 prefill_token_budget: int | None = None,
                 kv_shards: int = 1, prefix_cache: bool = True,
                 host_kv_pages: int = 0,
                 commit_calib_seed: int | None = None):
        """obs_policy: the paper enables out-block streaming only for the
        largest chunk (§7.2) — "large_chunk" applies OBS when the scheduler
        picks chunk == block_size; "off"/"always" override.

        prefix_cache: register finished prompt prefills in the allocator's
        trie and attach matching pages to later admissions (inert for
        traces without real ``prompt_tokens``).  host_kv_pages > 0 attaches
        the host spill tier: preemption victims spill (and swap back on
        re-admission) when the transfer beats re-prefilling."""
        if kv_admission not in ("incremental", "reserve"):
            raise ValueError(f"unknown kv_admission {kv_admission!r}")
        if prefill_mode not in ("chunked", "wave"):
            raise ValueError(f"unknown prefill_mode {prefill_mode!r}")
        self.cfg = cfg
        self.analytic = AnalyticDeviceModel(cfg, device, n_chips)
        self.sim = CommitSimulator(tokens_per_step, gamma, cfg.block_size,
                                   cfg.confidence_threshold, seed,
                                   calib_seed=commit_calib_seed)
        self.kv_shards = kv_shards
        self.kv = PagedKVAllocator(kv_pool_pages, page_size,
                                   kv_shards=kv_shards)
        self.kv_admission = kv_admission
        self.grows_kv = kv_admission == "incremental"
        self.decode_mode = decode_mode
        self.obs = obs
        self.obs_policy = "always" if obs else obs_policy
        self.include_prefill = include_prefill
        self.prefill_mode = prefill_mode
        align = _prefill_align(page_size, cfg)
        target_bc = None
        if prefill_token_budget is None and prefill_mode == "chunked":
            # adaptive default: fill each tick up to the device's
            # compute-saturation workload (clamped to sane bounds)
            target_bc = int(min(max(self.analytic.saturation_ew(), align),
                                8192))
        self._prefill = PrefillScheduler(prefill_token_budget, align,
                                         target_bc=target_bc)
        self._prefix_align = align
        self.prefix_cache = prefix_cache
        if host_kv_pages:
            self.kv.attach_host(host_kv_pages)
        # analytic bytes per page for the swap-vs-recompute cost model and
        # the swap byte counters (the sim pool has no real storage)
        self._page_bytes = kv_bytes_per_token(cfg) * page_size
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_hit_tokens = 0
        self.prefill_tokens_history: list[int] = []
        self._states: dict[int, object] = {}
        self._seed = seed
        self._req_rng: dict[int, np.random.Generator] = {}
        # telemetry: dispatch/byte counters mirror the real backend's — one
        # fused dispatch per tick with decode work, one standalone forward
        # for a prefill-only tick, and the 2·B·c conf/token scalars (16
        # bytes per window slot) the fused step returns to the host
        self.decode_dispatches = 0
        self.prefill_dispatches = 0
        self.host_transfer_bytes = 0
        # shard-aware split of the dispatch accounting: the *_dispatches
        # counters above stay LOGICAL (one per engine tick phase, however
        # many kv shards fan the work out) so trace_view phase attribution
        # never multiply-counts; device_dispatches tracks the per-shard
        # device programs and collective_bytes the analytic cross-shard
        # partial-merge traffic
        self.device_dispatches = 0
        self.collective_bytes = 0
        self.last_prefill_plan: list[tuple[int, int, int]] = []

    def _rng_of(self, rid: int) -> np.random.Generator:
        rng = self._req_rng.get(rid)
        if rng is None:
            rng = self._req_rng[rid] = np.random.default_rng(
                np.random.SeedSequence([self._seed, rid]))
        return rng

    # ------------------------------------------------------------------
    def _prefix_lookup(self, req: Request):
        """Admission-time prefix match, with the host-tier cost model
        applied: chain pages resident only on the host are swapped back
        only when the transfer beats recomputing their tokens, else the
        match truncates to its device-resident head."""
        if not self.prefix_cache or req.prompt_tokens is None \
                or self.kv_admission == "reserve":
            return None
        m = self.kv.lookup_prefix(req.prompt_tokens, req.prompt_len,
                                  align=self._prefix_align)
        if m is not None and m.n_host:
            swap_s = m.n_host * self._page_bytes / self.analytic.device.host_bw
            re_s = self.analytic.step_latency(
                1, m.n_host * self.kv.page_size, ctx=m.covered / 2)
            if swap_s >= re_s:
                m = m.device_only(self._prefix_align)
        return m

    def _register(self, req: Request):
        """Index a fully prefilled prompt in the prefix trie."""
        if self.prefix_cache and self.kv_admission != "reserve":
            self.kv.register_prefix(req.rid, req.prompt_tokens,
                                    limit=req.prompt_len)

    def admit_pages(self, req: Request) -> int:
        """Pages claimed at admission — the cluster admission policy's
        reservation unit (prompt-only under incremental growth, *net of
        prefix hits*: device-cached pages attach without new pages)."""
        if self.kv_admission == "reserve":
            return self.kv.pages_for(req.prompt_len + req.max_new_tokens)
        if self.kv.is_spilled(req.rid):
            return self.kv.spilled_pages(req.rid)
        m = self._prefix_lookup(req)
        if m is not None:
            return self.kv.pages_for(req.prompt_len) - m.n_device
        return self.kv.pages_for(req.prompt_len)

    def can_admit(self, req: Request) -> bool:
        total = req.prompt_len + req.max_new_tokens
        if self.kv_admission == "reserve":
            return self.kv.can_admit(total)
        # prompt pages must be free now; the full footprint must fit the
        # pool *ever*, else a lone request could deadlock mid-decode
        if self.kv.pages_for(total) > self.kv.n_pages:
            return False
        if self.kv.is_spilled(req.rid):
            return self.kv.can_swap_in(req.rid)
        m = self._prefix_lookup(req)
        if m is not None:
            return self.kv.can_admit_prefix(req.prompt_len, m)
        return self.kv.can_admit(req.prompt_len)

    def admit(self, req: Request) -> float:
        if self.kv.is_spilled(req.rid):
            # spill-resume: the decode state and per-request RNG stream
            # were retained at spill time, so the trajectory continues
            # exactly where preemption stopped it; admission charges the
            # host→device transfer instead of a re-prefill
            n = self.kv.spilled_pages(req.rid)
            self.kv.swap_in_request(req.rid)
            if not self.include_prefill:
                return 0.0
            return n * self._page_bytes / self.analytic.device.host_bw
        mode = _decode_mode_for(self.cfg, self.decode_mode)
        if mode == "ar":
            st = ARState(req.prompt_len, req.max_new_tokens)
        else:
            st = ChunkedDecodeState(
                prompt_len=req.prompt_len, max_new_tokens=req.max_new_tokens,
                block_size=self.cfg.block_size,
                threshold=self.cfg.confidence_threshold,
                mask_token=self.cfg.mask_token_id, eos_token=None,
                mode=mode, obs=self.obs)
        self._states[req.rid] = st
        covered = 0
        if self.kv_admission == "reserve":
            self.kv.allocate(req.rid, req.prompt_len + req.max_new_tokens)
        else:
            m = self._prefix_lookup(req)
            if m is not None:
                self.kv.allocate_prefix(req.rid, req.prompt_len, m)
                self.prefix_hits += 1
                self.prefix_hit_tokens += m.covered
                covered = m.covered
            else:
                if self.prefix_cache and req.prompt_tokens is not None:
                    self.prefix_misses += 1
                self.kv.allocate(req.rid, req.prompt_len)
        if not self.include_prefill:
            self._register(req)
            return 0.0
        if self.prefill_mode == "chunked":
            # prefill latency is charged chunk-by-chunk inside decode
            # ticks; cached tokens never enter the budget
            if self._prefill.add(req, start=covered):
                self._register(req)
            return 0.0
        # wave: only the uncovered prompt span is charged synchronously
        self._register(req)
        if covered >= req.prompt_len:
            return 0.0
        if covered == 0:
            return self.analytic.step_latency(1, req.prompt_len,
                                              ctx=req.prompt_len / 2)
        rem = req.prompt_len - covered
        return self.analytic.step_latency(1, rem, ctx=covered + rem / 2)

    def release(self, rid: int):
        self._prefill.remove(rid)
        if self.kv.is_spilled(rid):
            self.kv.discard_spilled(rid)
        else:
            self.kv.free(rid)
        self._states.pop(rid)
        self._req_rng.pop(rid, None)

    def spill(self, rid: int, force: bool = False) -> bool:
        """Preempt→spill: move the victim's pages to the host tier, keep
        its decode state + RNG stream, and resume via swap-in at
        re-admission — the preemption costs a transfer, not a re-prefill
        (and the resumed trajectory is identical to an uninterrupted run).
        Returns False — caller falls back to the discard path — when
        there is no host tier, the victim is still mid-prefill (the
        cursor would be lost), or the cost model says recomputing its
        tokens is cheaper than the round-trip transfer.  ``force`` skips
        the cost model (a drain ahead of a replica crash wants the state
        preserved even when a healthy-path preemption would recompute)
        but never the safety guards."""
        if self.kv.host is None or self._prefill.pending(rid) \
                or self.kv.is_spilled(rid):
            return False
        st = self._states.get(rid)
        if st is None:
            return False
        if not force:
            toks = st.prompt_len + st.frozen
            swap_s = swap_cost_s(self.kv.table_len(rid), self._page_bytes,
                                 self.analytic.device)
            re_s = self.analytic.step_latency(1, toks, ctx=toks / 2)
            if swap_s >= re_s:
                return False
        return self.kv.spill_request(rid) is not None

    # -- cross-replica migration / crash support -----------------------
    def migrate_out(self, rid: int) -> dict | None:
        """Detach a host-spilled request into a portable ticket: the KV
        payload plus the decode state and the per-request RNG stream.
        ``migrate_in`` on a peer backend resumes the exact trajectory —
        the sim's committed tokens depend only on the RNG stream and the
        window-size sequence, both of which travel."""
        if not self.kv.is_spilled(rid):
            return None
        payload = self.kv.export_spilled(rid)
        if payload is None:
            return None
        return {"payload": payload, "state": self._states.pop(rid),
                "rng": self._req_rng.pop(rid, None)}

    def migrate_in(self, req: Request, ticket: dict) -> bool:
        """Adopt a migrated request: its spill payload enters this
        backend's host tier and its decode state + RNG stream install
        under the same rid.  The normal spill-resume ``admit`` path then
        swaps it onto the device.  False ⇒ this replica cannot host it
        (allocator unchanged; caller should fall back to re-prefill)."""
        if not self.kv.adopt_spilled(req.rid, ticket["payload"]):
            return False
        self._states[req.rid] = ticket["state"]
        if ticket.get("rng") is not None:
            self._req_rng[req.rid] = ticket["rng"]
        return True

    def crash_reset(self):
        """Simulated replica death: all decode state, RNG streams,
        prefill cursors, and KV contents (tables, spills, prefix cache)
        are lost.  The allocator comes back empty and leak-free — what a
        fresh process would see."""
        self._prefill.queue = []
        self._prefill.cursor = {}
        self._states.clear()
        self._req_rng.clear()
        self.kv.crash_wipe()

    def state(self, rid: int):
        return self._states[rid]

    def step_page_deficit(self, rids, chunk: int) -> int:
        if self.kv_admission == "reserve" or not rids:
            return 0
        rids = [r for r in rids if not self._prefill.pending(r)]
        if not rids:
            return 0
        return _step_page_deficit(self.kv, self._states, rids, chunk)

    def prefill_tick_tokens(self) -> int:
        """Prompt tokens the next tick's prefill phase will process — the
        saturation signal the elastic scheduler folds into chunk choice."""
        backlog = self._prefill.backlog
        return min(self._prefill.tick_budget(), backlog)

    def decode_batch_size(self, rids) -> int:
        """Requests the next decode dispatch will actually include —
        mid-prefill rids sit the dispatch out (wave/synchronous prefill
        never leaves any pending)."""
        if self.prefill_mode == "wave":
            return len(rids)
        return sum(1 for r in rids if not self._prefill.pending(r))

    def telemetry_counters(self) -> dict:
        """Cumulative counters the tracer samples once per tick."""
        ks = self.kv.stats
        return {"decode_dispatches": self.decode_dispatches,
                "prefill_dispatches": self.prefill_dispatches,
                "host_transfer_bytes": self.host_transfer_bytes,
                "device_dispatches": self.device_dispatches,
                "collective_bytes": self.collective_bytes,
                "prefill_backlog": self._prefill.backlog,
                "prefill_tick_tokens": self.last_prefill_plan
                and sum(n for _, _, n in self.last_prefill_plan) or 0,
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "prefix_hit_tokens": self.prefix_hit_tokens,
                "pages_shared": self.kv.pages_shared,
                "cow_copies": ks["cow_copies"],
                "swap_in_bytes": int(ks["swap_in_pages"] * self._page_bytes),
                "swap_out_bytes": int(ks["swap_out_pages"]
                                      * self._page_bytes)}

    def _prefill_phase(self, live_bc: int = 0) -> tuple[int, float]:
        """Advance this tick's prefill chunks (FCFS, budget-bounded);
        returns (tokens, token-weighted mean context) for the tick's fused
        latency charge.  The chunks are co-batched with the decode dispatch
        — weights stream once per tick — so their cost is the marginal
        ``b·c`` workload they add, not a standalone per-chunk forward
        (which would re-pay the weight-read floor once per chunk)."""
        self.last_prefill_plan = []
        if not self._prefill.queue:
            return 0, 0.0
        plan = self._prefill.plan(live_bc)
        tokens = sum(n for _, _, n in plan)
        ctx = sum((off + n / 2) * n for _, off, n in plan) / max(tokens, 1)
        for req, off, n in plan:
            if self._prefill.advance(req.rid, n):
                self._register(req)
        self.prefill_tokens_history.append(tokens)
        self.last_prefill_plan = [(req.rid, off, n) for req, off, n in plan]
        self.host_transfer_bytes += 16 * len(plan)  # [B] conf/argmax scalars
        return tokens, ctx

    # ------------------------------------------------------------------
    def _step_slide_batched(self, rids, states, chunk, infos, ctxs,
                            eff_chunks):
        """Slide-mode step, vectorized across the batch via
        ``batch_windows`` / ``batch_apply_step``.  Draw sizes and order per
        request match the historical scalar loop, from each request's own
        stream — so trajectories are bit-identical to serving the request
        in any batch mix."""
        obs = (self.obs_policy == "always" or
               (self.obs_policy == "large_chunk"
                and chunk >= self.cfg.block_size))
        for st in states:
            st.obs = obs
        win, _, valid, cai = batch_windows(states, chunk)
        B, c = win.shape
        validm = np.arange(c)[None, :] < valid[:, None]
        unc = validm & ~cai
        first_unc = np.where(unc.any(axis=1), unc.argmax(axis=1), valid)
        depths = np.maximum(np.arange(c)[None, :] - first_unc[:, None], 0)
        conf = np.zeros((B, c))
        tok = np.zeros((B, c), np.int64)
        for i in np.nonzero(valid > 0)[0]:
            rng = self._rng_of(rids[i])
            conf[i] = self.sim.confidences(depths[i], rng=rng)
            tok[i] = rng.integers(5, 1000, size=c)
        commit, n_adv = batch_apply_step(states, conf, tok, valid, cai)
        for i, (rid, st) in enumerate(zip(rids, states)):
            if valid[i] == 0:
                infos[rid] = StepInfo(0, np.zeros(c, bool), 0, st.done)
                ctxs.append(st.prompt_len + st.frozen)
                continue
            st.advance(int(n_adv[i]))
            infos[rid] = StepInfo(int(commit[i].sum()), commit[i],
                                  int(valid[i]), st.done)
            ctxs.append(st.prompt_len + st.frozen)
            eff_chunks.append(int(valid[i]))

    def decode_step(self, rids, chunk: int):
        live_b = sum(1 for r in rids if not self._prefill.pending(r))
        pf_tokens, pf_ctx = self._prefill_phase(live_b * chunk)
        decode_rids = [r for r in rids if not self._prefill.pending(r)]
        if self.kv_admission == "incremental" and decode_rids:
            if self.prefix_cache:
                # COW before the step's first write can land in a shared
                # (or parked-registered) page; no-op for private tables
                for rid in decode_rids:
                    st = self._states[rid]
                    if not st.done:
                        lo = st.prompt_len + st.frozen
                        if isinstance(st, ARState):
                            lo -= 1      # AR rewrites its last position
                        self.kv.ensure_private(
                            rid, lo, _worst_step_len(st, chunk))
            # transactional worst-case reservation BEFORE any state mutates
            _reserve_step(self.kv, self._states, decode_rids, chunk)
        infos = {}
        ctxs, eff_chunks = [], []
        states = [self._states[rid] for rid in decode_rids]
        if states and not isinstance(states[0], ARState) \
                and states[0].mode == "slide":
            self._step_slide_batched(decode_rids, states, chunk, infos,
                                     ctxs, eff_chunks)
        else:
            # AR and block-pinned (hybrid) stay on the scalar path: AR is a
            # single RNG draw per rid, pinned windows have per-step widths
            for rid, st in zip(decode_rids, states):
                if isinstance(st, ARState):
                    st.commit(int(self._rng_of(rid).integers(5, 1000)))
                    infos[rid] = StepInfo(1, np.ones(1, bool), 1, st.done)
                    ctxs.append(st.prompt_len + st.frozen)
                    eff_chunks.append(1)
                    continue
                toks, start, valid, cai = st.window(chunk)
                if valid == 0:
                    infos[rid] = StepInfo(0, np.zeros(len(toks), bool), 0,
                                          st.done)
                    ctxs.append(st.prompt_len + st.frozen)
                    continue
                rng = self._rng_of(rid)
                first_unc = next((i for i in range(valid) if not cai[i]),
                                 valid)
                depths = np.maximum(np.arange(len(toks)) - first_unc, 0)
                conf = self.sim.confidences(depths, rng=rng)
                tok = rng.integers(5, 1000, size=len(toks))
                commit_mask, n_adv = st.apply_step(conf, tok, valid, cai)
                st.advance(n_adv)
                infos[rid] = StepInfo(int(commit_mask.sum()), commit_mask,
                                      valid, st.done)
                ctxs.append(st.prompt_len + st.frozen)
                eff_chunks.append(valid)
        if self.kv_admission == "incremental":
            _trim_step(self.kv, self._states, decode_rids)
        for rid in rids:                      # still-prefilling: idle info
            if rid not in infos:
                infos[rid] = StepInfo(0, np.zeros(1, bool), 0, False)
        if not decode_rids:
            # prefill-only tick: one batched chunk forward
            self.prefill_dispatches += 1
            self.device_dispatches += self.kv_shards
            self.collective_bytes += _split_kv_collective_bytes(
                self.kv_shards, self.cfg.n_layers, self.cfg.n_heads,
                self.cfg.hd, 1, pf_tokens)
            return self.analytic.step_latency(1, pf_tokens, pf_ctx), infos
        b = max(1, len(decode_rids))
        c_eff = max(1, int(round(float(np.mean(eff_chunks)))) if eff_chunks
                    else 1)
        # one fused dispatch per decode tick (prefill chunks ride it);
        # host pulls the 2·[B, c] conf/token scalars back
        self.decode_dispatches += 1
        self.device_dispatches += self.kv_shards
        self.collective_bytes += _split_kv_collective_bytes(
            self.kv_shards, self.cfg.n_layers, self.cfg.n_heads,
            self.cfg.hd, b, c_eff + -(-pf_tokens // b))
        self.host_transfer_bytes += 16 * b * c_eff
        ctx = float(np.mean(ctxs)) if ctxs else 1.0
        if pf_tokens:
            # fused tick: prefill chunks ride the decode dispatch — charge
            # the combined b·c workload at the token-weighted context
            dec_tokens = b * c_eff
            ctx = (ctx * dec_tokens + pf_ctx * pf_tokens) \
                / (dec_tokens + pf_tokens)
            return self.analytic.step_latency(b, c_eff + pf_tokens / b,
                                              ctx), infos
        return self.analytic.step_latency(b, c_eff, ctx), infos




# ===========================================================================
# Real-model backend
# ===========================================================================

class ModelBackend:
    """Real-model backend.

    For the attention-only families (``model.supports_paged()``), committed
    KV lives in a :class:`PagedKVAllocator`-owned page pool on the
    model's device, read through block tables by the chunked-paged-attention
    kernel (its plain version for ``attn_impl="ref"`` or CPU tensors).
    Admission claims **prompt pages only**; each decode step reserves its
    worst-case growth, freezes realized commits into the pool, and trims the
    rest back — the same memory-elastic semantics as :class:`SimBackend`.

    **Chunked prefill** (``prefill_mode="chunked"``, the default): a
    per-request cursor resumes ``TransformerLM.prefill_chunk_paged`` from
    its offset, and each decode tick runs at most one budget-bounded,
    page-aligned prefill dispatch before the decode dispatch.  **Wave
    prefill** (``prefill_mode="wave"``): the whole backlog runs as ONE
    ``[Bp, Tp]`` pow-2-bucketed ``TransformerLM.prefill_paged`` dispatch
    (block-diffusion kernel once per layer) before the decode dispatch;
    the prefix cache neither looks up nor registers in this mode.  Under a
    fixed chunk schedule both modes commit the same tokens.  Each dispatch
    returns only its confidence/argmax scalars (``8·Bp`` bytes for
    prefill, ``8·Bp·c`` for decode) to the host, counted in
    ``host_transfer_bytes``.  An AR request gets its prefill-derived first
    token at the end of the tick its last chunk lands.

    **Prefill sizing** follows the device served on (``_card_spec``: the
    card's name picks its roofline from ``DEVICES``).  On a known card,
    with no explicit ``prefill_token_budget``, each tick's prefill budget
    is the saturation point of the prefill dispatch itself
    (``saturation_ew()`` aligned down, clamped to [align, 8192]: 448
    tokens for SDAR-8B on the H100).  It is not net of the decode batch's
    ``b·c``, as the ``SimBackend``'s rule is: there the chunks ride the
    decode dispatch, while here the prefill chunk is a dispatch of its own
    with its own pass over the weights, so below its saturation point a
    longer chunk costs almost nothing more; the price is a longer stall
    for the decoding requests on a tick that carries a full budget.  Its
    padded shape is bounded (``PrefillScheduler.max_rows``: ``bucket(B) ×
    bucket(max n) ≤ bucket(budget)``), its token axis padded to at least
    one aligned chunk, and every shape it can take of at most
    ``SETUP_PREFILL_ROWS`` rows is captured at construction, before the
    first request (a larger one on its first use).  On the CPU, on a card
    not in the table, and with an explicit budget, the reference's rule
    holds: ``CPU_HOST``'s ``target_bc − b·c``, which clamps to one aligned
    chunk for these models, or the fixed budget; so a CPU backend plans as
    the reference.
    ``prefill_padded_tokens`` counts the padded rows of every prefill
    dispatch.

    The pool is updated in place by every dispatch, COW copy and swap-in
    (the torch form of the JAX package's donation contract):
    ``kv.k_pages.data_ptr()`` is fixed for the backend's life.

    **Captured dispatches** (``graphs``; the torch form of the JAX
    package's jitted dispatches): on a CUDA device every paged dispatch —
    decode, chunked prefill, wave prefill — replays one CUDA graph per
    bucketed shape (:class:`~repro_torch.serving.graphs.DispatchGraphs`),
    captured at the bucket's first use; so do the pool's COW copies and
    swap-ins (kinds ``copy`` and ``swap_in``, one graph a pool block and
    pow-2 page count: ``PagedKVAllocator._pool_dispatch``) and every slot
    dispatch (see below).  ``graphs=None`` turns it on for a
    CUDA device and off elsewhere; ``False`` runs every dispatch eagerly
    (the eager twin a captured run is held to); a capturer object (e.g.
    ``graphs.RerunCapturer()`` on the CPU) stands in for the card's.  The
    counters count calls, captured or not.

    **Sharded pool** (``kv_shards > 1``): the page count rounds up to a
    multiple of ``kv_shards``, and the pool splits into ``kv_shards``
    blocks over the ``kv`` axis of ``kv_mesh`` (default
    ``make_kv_mesh(kv_shards)``: one card a shard, raising when fewer are
    visible; ``make_kv_mesh(S, devices=[d] * S)`` puts every shard on one
    device).  Every decode and chunked-prefill dispatch reads the pool
    split-KV — the paged kernel once a shard a layer, over that shard's
    block with its local tables — and merges the partials exactly; every
    write, the wave prefill's too, stays on its page's shard, and each
    block's ``data_ptr`` is fixed.  ``device_dispatches`` counts
    ``kv_shards`` a logical dispatch and ``collective_bytes`` the analytic
    cross-shard merge traffic (``_split_kv_collective_bytes``).

    **Recurrent-slot mode** (ssm, hybrid): recurrent states cannot be
    paged, so these families keep a fixed ``n_slots``-row cache
    (``TransformerLM.init_cache``), updated in place for the backend's life.
    Admission prefills one request into a free slot, its prompt padded with
    zeros to ``max_len`` as the reference does (so the slot's states have
    also run over the padding); rwkv decodes AR with ``advance_states`` at
    T = 1, the hybrid block-pinned with one ``chunk_forward`` at ``c =
    block_size`` a tick and one ``advance_states`` a block commit.  Every
    dispatch runs all ``n_slots`` rows; a masked merge keeps the states of
    the rows that did not take part.  A window and an AR step pull their
    ``[n_slots, c, V]`` fp32 logits to the host, which samples them (a
    block commit's logits are never fetched, as in the reference); like
    the reference, this mode counts no dispatches and no host bytes.  The
    pool's options (pages, prefill mode and budget, prefix cache, host
    tier, shards and mesh) are accepted and unused.  Captured, the slot
    dispatches are the reference's four jits: ``slot_prefill`` (one graph,
    keyed ``(max_len,)``: slot, length and the padded prompt are static
    inputs), ``window`` (``(n_slots, block_size)``) and ``advance`` with
    the masked merge inside (``(n_slots, T)``; T is never padded, since the
    scans would run the states over the padding, so one graph a distinct
    T, as the reference retraces per T).  A replay reads the slot cache
    afresh (``_release_slot`` and ``crash_reset`` write it in place), and
    raises if it moved.

    **Spans** (``set_tracer``; the engine hands its tracer over, and a
    backend used with no engine holds ``NULL_TRACER``): inside the
    engine's ``engine.step`` the paged path opens ``prefill.plan`` (the
    plan, COW, tables and padded host arrays), ``prefill.dispatch``,
    ``prefill.fetch`` (the host's wait on the device), ``prefill.advance``
    (cursors, first tokens, ``register_prefix``), ``kv.reserve`` (the
    window's COW and the page reservation), ``decode.window``
    (``batch_windows``, ``freeze_run``), ``decode.dispatch`` (tables,
    padding and the dispatch), ``decode.fetch``, ``decode.commit``
    (``batch_apply_step``, ``advance``, each ``StepInfo``) and
    ``kv.trim``; the slot path ``slot.prefill``, ``slot.dispatch``,
    ``slot.fetch`` and ``slot.sample`` (the host's fp64 sampling).  A
    dispatch span carries its ``batch`` and ``tokens`` (a prefill's also
    its ``padded`` rows, Bp × Tp) and holds the graph cache's
    ``graph.load``/``graph.replay``/``graph.capture``, or one
    ``graph.eager`` when nothing is captured.
    """

    tracer = NULL_TRACER

    def __init__(self, model, params, n_slots: int = 8, max_len: int = 512,
                 decode_mode: str = "elastic", obs: bool = False,
                 cache_dtype=torch.float32,
                 kv_pages: int | None = None, page_size: int | None = None,
                 attn_impl: str | None = None,
                 prefill_mode: str = "chunked",
                 prefill_token_budget: int | None = None,
                 kv_shards: int = 1, prefix_cache: bool = True,
                 host_kv_pages: int = 0, device="cuda", kv_mesh=None,
                 graphs=None):
        if prefill_mode not in ("chunked", "wave"):
            raise ValueError(f"unknown prefill_mode {prefill_mode!r}")
        self.device = torch.empty(0, device=device).device   # cuda → cuda:N
        for name, t in params.items():
            if t.device != self.device:
                raise ValueError(f"param {name} is on {t.device}, the "
                                 f"backend on {self.device}")
        self.model = model
        self.cfg = model.cfg
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.decode_mode = decode_mode
        self.obs = obs
        self.paged = model.supports_paged()
        self.grows_kv = self.paged
        self.prefill_mode = prefill_mode
        self._states: dict[int, object] = {}
        self._req: dict[int, Request] = {}
        # hot-path telemetry
        self.decode_dispatches = 0       # decode dispatches
        self.prefill_dispatches = 0      # prefill dispatches
        self.prefill_padded_tokens = 0   # their padded rows, Bp × Tp
        self.host_transfer_bytes = 0     # device→host bytes (conf + tok)
        self.device_dispatches = 0
        self.collective_bytes = 0
        self.kv_shards = kv_shards
        self.prefill_tokens_history: list[int] = []  # prompt tokens per tick
        self.last_prefill_plan: list[tuple[int, int, int]] = []
        self._impl = attn_impl if attn_impl is not None \
            else self.cfg.paged_attn_impl
        if not self.paged:
            self.kv = None
            self.prefix_cache = False
            self.cache = model.init_cache(n_slots, max_len, dtype=cache_dtype,
                                          device=self.device)
            self._slot_of: dict[int, int] = {}
            self._free_slots = list(range(n_slots - 1, -1, -1))
            self.graphs = self._graph_cache(graphs)
            return

        ps = page_size if page_size is not None else self.cfg.kv_page_size
        if kv_pages is None:
            # mirror the historical dense cache's capacity by default
            kv_pages = n_slots * (-(-max_len // ps))
        # sharded pool: pages split evenly across shards
        kv_pages = -(-kv_pages // kv_shards) * kv_shards
        self.kv = PagedKVAllocator(kv_pages, ps, kv_shards=kv_shards)
        self._kv_shard = None
        if kv_shards > 1:
            mesh = kv_mesh if kv_mesh is not None else make_kv_mesh(kv_shards)
            self._kv_shard = KVShardSpec(mesh, kv_shards)
            self.kv.init_storage(*model.paged_kv_dims(), dtype=cache_dtype,
                                 shard=self._kv_shard)
        else:
            self.kv.init_storage(*model.paged_kv_dims(), dtype=cache_dtype,
                                 device=self.device)
        self._table_width = self.kv.pages_for(max_len)
        self._n_attn_layers = model.paged_kv_dims()[0]
        # cost model of the device served on, for swap-vs-recompute and
        # prefill sizing: a known card's roofline, else the reference's
        # CPU_HOST spec (so a CPU backend plans as the reference does)
        card = _card_spec(self.device)
        self._analytic = AnalyticDeviceModel(self.cfg, card or CPU_HOST)
        align = _prefill_align(ps, self.cfg)
        budget, target_bc, max_rows = prefill_token_budget, None, None
        if prefill_token_budget is None and prefill_mode == "chunked":
            if card is not None:        # the dispatch's own saturation
                budget = own_prefill_budget(self._analytic, align)
                max_rows = _pow2(budget)
            else:                       # the reference's net rule
                target_bc = int(min(max(self._analytic.saturation_ew(),
                                        align), 8192))
        self._prefill = PrefillScheduler(budget, align, target_bc=target_bc,
                                         max_rows=max_rows)
        self._prefix_align = align
        self.prefix_cache = prefix_cache
        if host_kv_pages:
            self.kv.attach_host(host_kv_pages)
        self._page_bytes = self.kv.page_bytes
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_hit_tokens = 0
        self.graphs = self._graph_cache(graphs)
        self.kv.graphs = self.graphs        # COW copies and swap-ins
        if self.graphs is not None and self._prefill.max_rows is not None:
            self._capture_prefill_shapes()

    def _capture_prefill_shapes(self):
        """Capture the chunked-prefill shapes the bounded planner can
        produce of at most ``SETUP_PREFILL_ROWS`` padded rows, before the
        first request: dispatches of valid-0 rows, which write nothing to
        the pool and count in no counter.  A larger shape is captured on
        its first use."""
        for bp, tp in self._prefill.shapes(self.max_len,
                                           SETUP_PREFILL_ROWS):
            z = np.zeros(bp, np.int64)
            host = dict(toks=np.zeros((bp, tp), np.int64), offs=z, valid=z,
                        tables=np.zeros((bp, self._table_width), np.int32),
                        **self._shard_offs([], bp))
            self.graphs.prepare(self._graph_key("chunk", host), self._chunk,
                                host)

    def set_tracer(self, tracer):
        """Open this backend's spans, and its graph cache's, on
        ``tracer``."""
        self.tracer = tracer
        if self.graphs is not None:
            self.graphs.tracer = tracer

    def _graph_cache(self, graphs):
        """The backend's ``DispatchGraphs`` (None: every dispatch eager);
        ``graphs`` as the constructor takes it."""
        if graphs is None:
            graphs = self.device.type == "cuda"
        if graphs is False:
            return None
        return DispatchGraphs(self.device, self._pool_ptrs,
                              capturer=None if graphs is True else graphs)

    # ------------------------------------------------------------------
    def _prefix_lookup(self, req: Request):
        """Admission-time prefix match (chunked mode only: the wave flush
        always re-prefills whole prompts from offset 0, which would
        rewrite attached shared pages).  Host-tier chain pages swap back
        only when the transfer beats recomputing their tokens."""
        if not self.prefix_cache or req.prompt_tokens is None \
                or self.prefill_mode != "chunked":
            return None
        m = self.kv.lookup_prefix(req.prompt_tokens, req.prompt_len,
                                  align=self._prefix_align)
        if m is not None and m.n_host:
            swap_s = m.n_host * self._page_bytes \
                / self._analytic.device.host_bw
            re_s = self._analytic.step_latency(
                1, m.n_host * self.kv.page_size, ctx=m.covered / 2)
            if swap_s >= re_s:
                m = m.device_only(self._prefix_align)
        return m

    def admit_pages(self, req: Request) -> int:
        """Pages claimed at admission (prompt-only incremental growth,
        net of prefix hits — attached device pages cost nothing)."""
        if not self.paged:
            return 0
        if self.kv.is_spilled(req.rid):
            return self.kv.spilled_pages(req.rid)
        m = self._prefix_lookup(req)
        if m is not None:
            return self.kv.pages_for(req.prompt_len) - m.n_device
        return self.kv.pages_for(req.prompt_len)

    def can_admit(self, req: Request) -> bool:
        total = req.prompt_len + req.max_new_tokens
        if total > self.max_len:
            return False
        if not self.paged:
            return bool(self._free_slots)
        # prompt pages free now; full footprint must fit the pool ever
        if self.kv.pages_for(total) > self.kv.n_pages:
            return False
        if self.kv.is_spilled(req.rid):
            return self.kv.can_swap_in(req.rid)
        m = self._prefix_lookup(req)
        if m is not None:
            return self.kv.can_admit_prefix(req.prompt_len, m)
        return self.kv.can_admit(req.prompt_len)

    def _make_state(self, req: Request):
        mode = _decode_mode_for(self.cfg, self.decode_mode)
        if mode == "ar":
            return ARState(req.prompt_len, req.max_new_tokens, req.eos_token)
        return ChunkedDecodeState(
            prompt_len=req.prompt_len, max_new_tokens=req.max_new_tokens,
            block_size=self.cfg.block_size,
            threshold=self.cfg.confidence_threshold,
            mask_token=self.cfg.mask_token_id, eos_token=req.eos_token,
            mode=mode, obs=self.obs)

    def admit(self, req: Request) -> float:
        self._req[req.rid] = req
        if not self.paged:
            self._states[req.rid] = self._make_state(req)
            self._admit_slot(req)
            return 0.0
        if self.kv.is_spilled(req.rid):
            # spill-resume: the decode state was retained at spill time;
            # one batched host→device copy restores the exact KV
            self.kv.swap_in_request(req.rid)
            return 0.0
        self._states[req.rid] = st = self._make_state(req)
        # claim the prompt's pages only; decode steps grow the table
        # incrementally, and the prefill forward itself is deferred to the
        # decode loop in budget-bounded page-aligned chunks
        m = self._prefix_lookup(req)
        if m is not None:
            self.kv.allocate_prefix(req.rid, req.prompt_len, m)
            self.prefix_hits += 1
            self.prefix_hit_tokens += m.covered
            start = m.covered
            if isinstance(st, ARState) and start >= req.prompt_len:
                # AR's first token comes from the prefill head at the last
                # prompt position, so keep (exactly) that token in the plan
                start = req.prompt_len - 1
            self._prefill.add(req, start=start)
        else:
            if self.prefix_cache and req.prompt_tokens is not None \
                    and self.prefill_mode == "chunked":
                self.prefix_misses += 1
            self.kv.allocate(req.rid, req.prompt_len)
            self._prefill.add(req)
        return 0.0

    def release(self, rid: int):
        if not self.paged:
            self._release_slot(rid)
            self._states.pop(rid)
            self._req.pop(rid)
            return
        # a mid-prefill victim's cursor is discarded with its pages
        self._prefill.remove(rid)
        if self.kv.is_spilled(rid):
            self.kv.discard_spilled(rid)
        else:
            self.kv.free(rid)
        self._states.pop(rid)
        self._req.pop(rid)

    def spill(self, rid: int, force: bool = False) -> bool:
        """Preempt→spill to the host tier (see :meth:`SimBackend.spill`):
        decode state is retained and re-admission swaps the exact KV bytes
        back.  False → caller uses the discard path."""
        if not self.paged or self.kv.host is None \
                or self._prefill.pending(rid) \
                or self.kv.is_spilled(rid):
            return False
        st = self._states.get(rid)
        if st is None:
            return False
        if not force:
            toks = st.prompt_len + st.frozen
            swap_s = swap_cost_s(self.kv.table_len(rid),
                                 self._page_bytes or 1.0,
                                 self._analytic.device)
            re_s = self._analytic.step_latency(1, toks, ctx=toks / 2)
            if swap_s >= re_s:
                return False
        return self.kv.spill_request(rid) is not None

    # -- cross-replica migration / crash support -----------------------
    def migrate_out(self, rid: int) -> dict | None:
        """Detach a host-spilled request into a portable ticket (KV bytes
        + decode state); see :meth:`SimBackend.migrate_out`."""
        if not self.paged or not self.kv.is_spilled(rid):
            return None
        payload = self.kv.export_spilled(rid)
        if payload is None:
            return None
        return {"payload": payload, "state": self._states.pop(rid),
                "rng": None, "req": self._req.pop(rid, None)}

    def migrate_in(self, req: Request, ticket: dict) -> bool:
        """Adopt a migrated request's spill payload + decode state; the
        spill-resume ``admit`` path then swaps the exact KV bytes onto
        this replica's pool."""
        if not self.paged or not self.kv.adopt_spilled(req.rid,
                                                       ticket["payload"]):
            return False
        self._states[req.rid] = ticket["state"]
        self._req[req.rid] = req
        return True

    def crash_reset(self):
        """Simulated replica death: decode states, prefill cursors, and
        all KV contents are dropped; the allocator comes back empty."""
        if self.paged:
            self._prefill.queue = []
            self._prefill.cursor = {}
            self.kv.crash_wipe()
        else:
            for rid in list(self._slot_of):
                self._release_slot(rid)
        self._states.clear()
        self._req.clear()

    def state(self, rid: int):
        return self._states[rid]

    def step_page_deficit(self, rids, chunk: int) -> int:
        if not self.paged or not rids:
            return 0
        # mid-prefill requests don't decode this tick
        rids = [r for r in rids if not self._prefill.pending(r)]
        if not rids:
            return 0
        return _step_page_deficit(self.kv, self._states, rids, chunk)

    def prefill_tick_tokens(self) -> int:
        """Prompt tokens the next tick's prefill phase will process — the
        saturation signal the elastic scheduler folds into chunk choice."""
        if not self.paged:
            return 0
        backlog = self._prefill.backlog
        if self.prefill_mode == "wave":
            return backlog
        return min(self._prefill.tick_budget(), backlog)

    def decode_batch_size(self, rids) -> int:
        """Requests the next decode dispatch will actually include —
        mid-prefill rids sit the dispatch out in chunked mode, but join it
        in wave mode (the wave flush completes before the dispatch)."""
        if not self.paged or self.prefill_mode == "wave":
            return len(rids)
        return sum(1 for r in rids if not self._prefill.pending(r))

    # ------------------------------------------------------------------
    def _pages_cache(self):
        return {"k_pages": self.kv.k_pages, "v_pages": self.kv.v_pages}

    def _pool_ptrs(self) -> tuple:
        """The ``data_ptr``\\ s of what every dispatch writes in place: the
        page pool's blocks, or the slot cache's tensors."""
        if not self.paged:
            return tuple(t.data_ptr() for t in _slot_tensors(self.cache))
        ks, vs, _ = self.kv.pool_blocks()
        return tuple(t.data_ptr() for t in list(ks) + list(vs))

    def _shard_offs(self, rids, padded: int) -> dict:
        """A sharded dispatch's host input ``shard_offs``: the rows' stripe
        offsets (padded rows: offset 0 — their ctx is 0, so never read);
        nothing for an unsharded pool."""
        if self._kv_shard is None:
            return {}
        so = np.zeros(padded, np.int32)
        so[:len(rids)] = self.kv.stripe_offsets(rids)
        return {"shard_offs": so}

    def _shard_args(self, t) -> dict:
        """The sharded pool's ``kv_shard`` and ``shard_offs`` arguments of a
        dispatch reading ``t`` (nothing for an unsharded pool)."""
        if self._kv_shard is None:
            return {}
        return {"kv_shard": self._kv_shard, "shard_offs": t["shard_offs"]}

    def _dispatch(self, kind: str, fn, **host) -> tuple:
        """One dispatch ``fn(t)`` of ``kind`` on the host arrays ``host``
        (each padded to its bucket), ``t`` holding them on the device by
        name: replayed from the graph of its key when ``self.graphs`` is
        set, else run eagerly.  Returns ``fn``'s outputs on the device: a
        paged dispatch's (conf, tok), a slot dispatch's (logits,)."""
        if self.graphs is None:
            with self.tracer.span("graph.eager"):
                return fn({k: torch.as_tensor(a, device=self.device)
                           for k, a in host.items()})
        return self.graphs.dispatch(self._graph_key(kind, host), fn, host)

    def _graph_key(self, kind: str, host: dict) -> tuple:
        """The graph cache's key of a dispatch on the padded ``host``."""
        return (kind, host["toks"].shape, self._impl, self.kv_shards)

    # the three dispatches, each on its static (or eager) inputs ``t``
    def _wave(self, t):
        (conf, tok), _ = self.model.prefill_paged(
            self.params, self._pages_cache(), t["toks"], t["lens"],
            t["tables"], head_mode="sample", impl=self._impl,
            kv_shard=self._kv_shard)
        return conf, tok

    def _chunk(self, t):
        conf, tok, _ = self.model.prefill_chunk_paged(
            self.params, self._pages_cache(), t["toks"], t["offs"],
            t["valid"], t["tables"], impl=self._impl, **self._shard_args(t))
        return conf, tok

    def _decode(self, t):
        conf, tok, _ = self.model.decode_step_paged(
            self.params, self._pages_cache(), t["toks"], t["start"],
            t["valid"], t["tables"], t["start"], t["n_adv"], impl=self._impl,
            **self._shard_args(t))
        return conf, tok

    def _account_device_dispatch(self, batch: int, tokens: int):
        self.device_dispatches += self.kv_shards
        self.collective_bytes += _split_kv_collective_bytes(
            self.kv_shards, self._n_attn_layers, self.cfg.n_heads,
            self.cfg.hd, batch, tokens)

    def _to_host(self, conf, tok):
        """The dispatch's one device→host transfer: its conf and tok."""
        conf = conf.cpu().numpy()
        tok = tok.cpu().numpy()
        self.host_transfer_bytes += conf.nbytes + tok.nbytes
        return conf, tok

    def _flush_prefills(self) -> set:
        """Wave mode: run the whole deferred backlog as ONE batched prefill
        forward (``[Bp, Tp]``, both pow-2 buckets) that scatters into the
        pool in place.  Only the ``[Bp]`` device-reduced conf/argmax
        scalars come back to the host.  Returns rids that received their
        prefill-derived first token (AR)."""
        tr = self.tracer
        reqs = list(self._prefill.queue)
        if not reqs:
            return set()
        with tr.span("prefill.plan"):
            B = len(reqs)
            Bp = _pow2(B)
            Tp = _pow2(max(r.prompt_len for r in reqs))
            toks = np.zeros((Bp, Tp), np.int64)
            lens = np.zeros(Bp, np.int32)
            tables = np.zeros((Bp, self._table_width), np.int32)
            tables[:B] = self.kv.batch_tables([r.rid for r in reqs],
                                              self._table_width)
            for i, r in enumerate(reqs):
                toks[i, :r.prompt_len] = np.asarray(r.prompt_tokens)
                lens[i] = r.prompt_len
        n_tokens = sum(r.prompt_len for r in reqs)
        with tr.span("prefill.dispatch", batch=B, tokens=n_tokens,
                     padded=Bp * Tp):
            conf, tok = self._dispatch("wave", self._wave, toks=toks,
                                       lens=lens, tables=tables)
            self.prefill_dispatches += 1
            self.prefill_padded_tokens += Bp * Tp
            # wave prefill never reads the paged prefix (scatter only)
            self.device_dispatches += self.kv_shards
        with tr.span("prefill.fetch"):
            conf, tok = self._to_host(conf, tok)
        with tr.span("prefill.advance"):
            fresh = set()
            for i, r in enumerate(reqs):
                self._prefill.advance(r.rid, r.prompt_len)
                st = self._states[r.rid]
                if isinstance(st, ARState):
                    st.commit(int(tok[i]))
                    fresh.add(r.rid)
            self.prefill_tokens_history.append(n_tokens)
            self.last_prefill_plan = [(r.rid, 0, r.prompt_len) for r in reqs]
        return fresh

    def _chunked_prefill_tick(self, live_bc: int = 0) -> set:
        """One dispatch advancing up to this tick's budget in prompt tokens
        of prefill cursors (FCFS, page-aligned chunk ends).  Returns rids
        whose prompt completed this tick AND received their
        prefill-derived first token (AR)."""
        tr = self.tracer
        with tr.span("prefill.plan"):
            plan = self._prefill.plan(live_bc)
            if not plan:
                return set()
            if self.prefix_cache:
                # COW before the chunk write can land in a shared page
                for req, off, n in plan:
                    self.kv.ensure_private(req.rid, off, off + n)
            B = len(plan)
            Bp, Tp = self._prefill.padded(B, max(n for _, _, n in plan))
            toks = np.zeros((Bp, Tp), np.int64)
            offs = np.zeros(Bp, np.int64)
            val = np.zeros(Bp, np.int64)
            tables = np.zeros((Bp, self._table_width), np.int32)
            tables[:B] = self.kv.batch_tables(
                [req.rid for req, _, _ in plan], self._table_width)
            for i, (req, off, n) in enumerate(plan):
                toks[i, :n] = np.asarray(req.prompt_tokens[off:off + n])
                offs[i] = off
                val[i] = n
        n_tokens = sum(n for _, _, n in plan)
        with tr.span("prefill.dispatch", batch=B, tokens=n_tokens,
                     padded=Bp * Tp):
            conf, tok = self._dispatch(
                "chunk", self._chunk, toks=toks, offs=offs, valid=val,
                tables=tables,
                **self._shard_offs([req.rid for req, _, _ in plan], Bp))
            self.prefill_dispatches += 1
            self.prefill_padded_tokens += Bp * Tp
            self._account_device_dispatch(Bp, Tp)
        with tr.span("prefill.fetch"):
            conf, tok = self._to_host(conf, tok)
        with tr.span("prefill.advance"):
            fresh = set()
            for i, (req, off, n) in enumerate(plan):
                if self._prefill.advance(req.rid, n):
                    st = self._states[req.rid]
                    if isinstance(st, ARState):
                        st.commit(int(tok[i]))
                        fresh.add(req.rid)
                    if self.prefix_cache:
                        # the prompt's pages now hold exactly the KV a
                        # fresh prefill would write — index them for reuse
                        self.kv.register_prefix(req.rid, req.prompt_tokens,
                                                limit=req.prompt_len)
            self.prefill_tokens_history.append(n_tokens)
            self.last_prefill_plan = [(req.rid, off, n)
                                      for req, off, n in plan]
        return fresh

    def _prefill_tick(self, live_bc: int = 0) -> set:
        self.last_prefill_plan = []
        if not self._prefill.queue:
            return set()
        if self.prefill_mode == "wave":
            return self._flush_prefills()
        return self._chunked_prefill_tick(live_bc)

    def telemetry_counters(self) -> dict:
        """Cumulative counters the tracer samples once per tick; with a
        graph cache, its captures, the host seconds they took (the
        set-up's included) and its replays."""
        g = self.graphs
        graphs = {} if g is None else {
            "graph_captures": len(g.entries), "graph_capture_s": g.capture_s,
            "graph_replays": g.replays}
        if not self.paged:
            return {"decode_dispatches": self.decode_dispatches,
                    "prefill_dispatches": self.prefill_dispatches,
                    "host_transfer_bytes": self.host_transfer_bytes,
                    **graphs}
        ks = self.kv.stats
        return {**graphs,
                "decode_dispatches": self.decode_dispatches,
                "prefill_dispatches": self.prefill_dispatches,
                "host_transfer_bytes": self.host_transfer_bytes,
                "device_dispatches": self.device_dispatches,
                "collective_bytes": self.collective_bytes,
                "prefill_backlog": self._prefill.backlog,
                "prefill_tick_tokens": self.last_prefill_plan
                and sum(n for _, _, n in self.last_prefill_plan) or 0,
                "prefill_padded_tokens": self.prefill_padded_tokens,
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "prefix_hit_tokens": self.prefix_hit_tokens,
                "pages_shared": self.kv.pages_shared,
                "cow_copies": ks["cow_copies"],
                "swap_in_bytes": int(ks["swap_in_pages"] * self._page_bytes),
                "swap_out_bytes": int(ks["swap_out_pages"]
                                      * self._page_bytes)}

    def _dispatch_window(self, rids, win, start, valid, n_adv):
        """Run one paged decode dispatch for an assembled window batch.

        ``start`` doubles as ``ctx_lens``: a slide window starts exactly at
        the committed prefix length, and an AR window sits at the last
        committed token with the prefix ending just before it.  Pads every
        host array to the pow-2 batch bucket (padded rows: table 0 / ctx 0
        / valid 0) and returns host (conf [B, c], tok [B, c]).  ONE fused
        dispatch (``model.decode_step_paged``) runs chunk-forward + freeze
        + on-device sampling on the pool in place, and only ``2·Bp·c``
        scalars come back.  The ``decode.dispatch`` span holds the tables
        and padding with the dispatch.
        """
        B, c = win.shape
        Bp = _pow2(B)
        tr = self.tracer
        with tr.span("decode.dispatch", batch=B, tokens=int(np.sum(valid))):
            tables = np.zeros((Bp, self._table_width), np.int32)
            tables[:B] = self.kv.batch_tables(rids, self._table_width)
            w = np.full((Bp, c), self.cfg.mask_token_id, np.int64)
            w[:B] = win
            s = np.zeros(Bp, np.int64)
            s[:B] = start
            v = np.zeros(Bp, np.int64)
            v[:B] = valid
            a = np.zeros(Bp, np.int64)
            a[:B] = n_adv
            conf, tok = self._dispatch("decode", self._decode, toks=w,
                                       start=s, valid=v, tables=tables,
                                       n_adv=a, **self._shard_offs(rids, Bp))
            self.decode_dispatches += 1
            self._account_device_dispatch(Bp, c)
        with tr.span("decode.fetch"):
            conf, tok = self._to_host(conf, tok)
        return conf[:B], tok[:B].astype(np.int64)

    def _step_ar_paged(self, ar_rids, infos):
        """AR decode over the page pool: c=1 window at the last committed
        token, prefix = everything before it; the input token's KV freezes
        into the pool every step (n_adv = 1)."""
        tr = self.tracer
        states = [self._states[rid] for rid in ar_rids]
        B = len(states)
        with tr.span("decode.window"):
            win = np.empty((B, 1), np.int64)
            start = np.empty(B, np.int64)
            for i, st in enumerate(states):
                win[i, 0] = st.committed[st.frozen - 1]
                start[i] = st.prompt_len + st.frozen - 1
            ones = np.ones(B, np.int64)
        _, tok = self._dispatch_window(ar_rids, win, start, ones, ones)
        with tr.span("decode.commit"):
            for i, (rid, st) in enumerate(zip(ar_rids, states)):
                st.commit(int(tok[i, 0]))
                infos[rid] = StepInfo(1, np.ones(1, bool), 1, st.done)

    def _step_diffusion_paged(self, diff_rids, chunk, infos):
        tr = self.tracer
        states = [self._states[rid] for rid in diff_rids]
        with tr.span("decode.window"):
            win, start, valid, cai = batch_windows(states, chunk)
            # the freeze run is known before the step (leading committed-
            # at-input positions) — this is what makes the fused freeze
            # possible
            n_adv = freeze_run(valid, cai)
        conf, tok = self._dispatch_window(diff_rids, win, start, valid,
                                          n_adv)
        with tr.span("decode.commit"):
            commit, n_adv_post = batch_apply_step(states, conf, tok, valid,
                                                  cai)
            # invariant: commits this step can never clamp the pre-step run
            assert (n_adv_post == n_adv).all(), (n_adv_post, n_adv)
            for i, (rid, st) in enumerate(zip(diff_rids, states)):
                st.advance(int(n_adv_post[i]))
                infos[rid] = StepInfo(int(commit[i].sum()), commit[i],
                                      int(valid[i]), st.done)

    def _split_ar(self, rids, infos):
        """Partition rids into (live AR, diffusion); AR requests already
        finished by their prefill-derived token get a no-op done StepInfo."""
        ar_rids, diff_rids = [], []
        for r in rids:
            st = self._states[r]
            if not isinstance(st, ARState):
                diff_rids.append(r)
            elif st.done:
                infos[r] = StepInfo(0, np.zeros(1, bool), 0, True)
            else:
                ar_rids.append(r)
        return ar_rids, diff_rids

    def decode_step(self, rids, chunk: int):
        if not self.paged:
            return 0.0, self._step_slots(rids)
        infos: dict[int, StepInfo] = {}
        live_b = sum(1 for r in rids if not self._prefill.pending(r))
        fresh = self._prefill_tick(live_b * chunk)
        # requests whose prompt is still mid-prefill sit this decode
        # dispatch out; ones whose last chunk just landed join it
        ready = [r for r in rids if not self._prefill.pending(r)]
        ar_rids, diff_rids = self._split_ar(ready, infos)
        live = ar_rids + diff_rids
        if live:
            with self.tracer.span("kv.reserve"):
                if self.prefix_cache:
                    # COW any shared page the worst-case window can touch
                    # before the dispatch writes the pool in place
                    for r in live:
                        st = self._states[r]
                        if st.done:
                            continue
                        lo = st.prompt_len + st.frozen
                        if isinstance(st, ARState):
                            lo -= 1
                        self.kv.ensure_private(r, lo,
                                               _worst_step_len(st, chunk))
                # worst-case page reservation; transactional OutOfPages
                # (nothing mutated yet) lets the engine preempt + retry
                _reserve_step(self.kv, self._states, live, chunk)
        if ar_rids:
            self._step_ar_paged(ar_rids, infos)
        if diff_rids:
            self._step_diffusion_paged(diff_rids, chunk, infos)
        if live:
            with self.tracer.span("kv.trim"):
                _trim_step(self.kv, self._states, live)
        for r in rids:                    # still-prefilling: idle info
            if r not in infos:
                infos[r] = StepInfo(0, np.zeros(1, bool), 0, False)
        for r in fresh:
            # surface the prefill-derived AR first token in this tick's
            # StepInfo so the engine stamps TTFT at the tick the last chunk
            # completed (valid_len stays untouched)
            fi = infos.get(r)
            if fi is None:
                infos[r] = StepInfo(1, np.ones(1, bool), 0,
                                    self._states[r].done)
            else:
                infos[r] = StepInfo(fi.n_committed + 1, fi.commit_mask,
                                    fi.valid_len, fi.done)
        return 0.0, infos

    # -- recurrent-slot mode -------------------------------------------------
    # the three slot dispatches, each on its static (or eager) inputs ``t``
    def _slot_prefill(self, t):
        logits, _ = self.model.prefill_slot(
            self.params, self.cache, t["toks"], t["lens"], t["slot"],
            impl=self._impl)
        return (logits,)

    def _window(self, t):
        logits, _ = self.model.chunk_forward(
            self.params, self.cache, t["toks"], t["start"], t["valid"],
            impl=self._impl)
        return (logits,)

    def _advance(self, t):
        """``advance_states`` and the reference's ``_merge``: the new states
        land only in the rows of ``t["mask"]`` (in place)."""
        logits, new = self.model.advance_states(
            self.params, self.cache, t["toks"], t["lens"], impl=self._impl)
        m = t["mask"]
        for key, st in self.cache.get("states", {}).items():
            for name, old in st.items():
                keep = m.view((1, -1) + (1,) * (old.dim() - 2))
                old.copy_(torch.where(keep, new["states"][key][name], old))
        return (logits,)

    @staticmethod
    def _fetch(logits) -> np.ndarray:
        """A slot dispatch's logits on the host, fetched only where the
        caller samples them (an AR step's, a window's, an AR admission's)."""
        return logits.cpu().numpy()

    def _admit_slot(self, req: Request):
        """Prefill one request into a free slot, its prompt padded with
        zeros to ``max_len`` (the reference's admission, padding and all):
        one ``slot_prefill`` dispatch whatever the slot or prompt length.
        An AR request commits its first token from the last prompt
        position's logits, sampled on the host."""
        tr = self.tracer
        slot = self._free_slots.pop()
        self._slot_of[req.rid] = slot
        toks = np.zeros(self.max_len, np.int64)
        pt = np.asarray(req.prompt_tokens, np.int64)
        toks[:len(pt)] = pt
        with tr.span("slot.prefill", batch=1, tokens=req.prompt_len):
            (logits,) = self._dispatch(
                "slot_prefill", self._slot_prefill, toks=toks,
                lens=np.array([req.prompt_len], np.int32),
                slot=np.array([slot], np.int64))
        st = self._states[req.rid]
        if isinstance(st, ARState):
            with tr.span("slot.fetch"):
                logits = self._fetch(logits)
            with tr.span("slot.sample"):
                _, tok = softmax_confidence(logits)
                st.commit(int(tok))

    def _release_slot(self, rid: int):
        """Free a slot: zero its ``len`` and its recurrent states (the fresh
        states are zeros), so no later dispatch sees the last occupant's.
        Its KV rows are overwritten by the next prefill."""
        slot = self._slot_of.pop(rid)
        self.cache["len"][slot] = 0
        for st in self.cache.get("states", {}).values():
            for t in st.values():
                t[:, slot] = 0
        self._free_slots.append(slot)

    def _step_ar_recurrent(self, ar_rids, infos):
        """AR decode for the recurrent-slot families: the last committed
        token of every live slot through ``advance_states`` (T = 1)."""
        B = self.n_slots
        toks = np.full((B, 1), self.cfg.mask_token_id, np.int64)
        lens = np.zeros(B, np.int32)
        mask = np.zeros(B, bool)
        for rid in ar_rids:
            st = self._states[rid]
            slot = self._slot_of[rid]
            toks[slot, 0] = st.committed[st.frozen - 1] if st.frozen else \
                self._req[rid].prompt_tokens[-1]
            lens[slot] = 1
            mask[slot] = True
        tr = self.tracer
        with tr.span("slot.dispatch", batch=len(ar_rids),
                     tokens=len(ar_rids)):
            (logits,) = self._dispatch("advance", self._advance, toks=toks,
                                       lens=lens, mask=mask)
        with tr.span("slot.fetch"):
            logits = self._fetch(logits)
        with tr.span("slot.sample"):
            for rid in ar_rids:
                st = self._states[rid]
                _, tok = softmax_confidence(logits[self._slot_of[rid], 0])
                st.commit(int(tok))
                infos[rid] = StepInfo(1, np.ones(1, bool), 1, st.done)

    def _step_slots(self, rids):
        """One tick of the recurrent-slot families: AR steps (ssm), then the
        hybrid's block-pinned diffusion — one ``chunk_forward`` at ``c =
        block_size`` over every slot, and one ``advance_states`` for each
        request whose step completed a run of committed tokens."""
        infos: dict[int, StepInfo] = {}
        ar_rids, diff_rids = self._split_ar(rids, infos)
        if ar_rids:
            self._step_ar_recurrent(ar_rids, infos)
        if not diff_rids:
            return infos

        B = self.n_slots
        c = self.cfg.block_size          # hybrid windows pin to the block
        win = np.full((B, c), self.cfg.mask_token_id, np.int64)
        start = np.zeros(B, np.int64)
        valid = np.zeros(B, np.int64)
        meta = {}
        for rid in diff_rids:
            st = self._states[rid]
            slot = self._slot_of[rid]
            toks, s, v, cai = st.window(c)
            win[slot, :len(toks)] = toks
            start[slot] = s
            valid[slot] = v
            meta[rid] = (cai, v)
        # the window's logits reach the host before a block commit replays
        # (graphs.py: one memory pool a backend)
        tr = self.tracer
        with tr.span("slot.dispatch", batch=len(diff_rids),
                     tokens=int(valid.sum())):
            (logits,) = self._dispatch("window", self._window, toks=win,
                                       start=start, valid=valid)
        with tr.span("slot.fetch"):
            logits = self._fetch(logits)

        block_commits = []
        with tr.span("slot.sample"):
            for rid in diff_rids:
                st = self._states[rid]
                slot = self._slot_of[rid]
                cai, v = meta[rid]
                conf, tok = softmax_confidence(logits[slot, :c])
                commit_mask, n_adv = st.apply_step(conf, tok, v, cai)
                if n_adv > 0:
                    block_commits.append((rid, slot, n_adv))
                infos[rid] = StepInfo(int(commit_mask.sum()), commit_mask, v,
                                      st.done)

        for rid, slot, n_adv in block_commits:
            st = self._states[rid]
            rel0 = st.frozen
            toks = np.full((B, n_adv), self.cfg.mask_token_id, np.int64)
            lens = np.zeros(B, np.int32)
            mask = np.zeros(B, bool)
            toks[slot] = st.committed[rel0:rel0 + n_adv]
            lens[slot] = n_adv
            mask[slot] = True
            # T = n_adv unpadded; the logits are never fetched
            with tr.span("slot.dispatch", batch=1, tokens=n_adv):
                self._dispatch("advance", self._advance, toks=toks,
                               lens=lens, mask=mask)
            st.advance(n_adv)
        return infos
