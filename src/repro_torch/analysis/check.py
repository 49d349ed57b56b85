"""Serving-invariant static analyzer CLI.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis.check [--json FILE]
        [--only hlo|lint] [--kv-shards 1,2] [--allowlist FILE]
        [--device cuda|cpu] [--verbose]

Runs both passes — the dispatch audit over the dispatch inventory and a
backend's captured dispatches (Pass 1, on ``--device``: the card by
default, which raises without one) and the
AST repo lint (Pass 2) — filters findings through the allowlist, prints a
report, and exits non-zero if any active finding remains.  ``--json``
additionally writes the structured findings (active + waived).

``--kv-shards 2`` audits a pool of 2 shards on a mesh whose every shard is
the chosen device (``make_kv_mesh(2, devices=[device] * 2)``).
"""

import argparse
import json
import os
import sys

from repro_torch.analysis import lint
from repro_torch.analysis.findings import apply_allowlist, load_allowlist

DEFAULT_ALLOWLIST = os.path.join(os.path.dirname(__file__), "allowlist.txt")


def _returned_pool(out, fallback):
    """The cache a dispatch returned (the dict holding ``k_pages``), or
    ``fallback`` when it returned none."""
    for node in (out if isinstance(out, (tuple, list)) else (out,)):
        if isinstance(node, dict) and "k_pages" in node:
            return node
        if isinstance(node, (tuple, list)):
            found = _returned_pool(node, None)
            if found is not None:
                return found
    return fallback


def audit_entry(e, device, verbose: bool = False, stats=None) -> list:
    """Run one inventory entry under the op trace and apply its rules;
    ``stats`` (a dict), when given, receives the dispatch's readings: its
    syncs, ops, FLOPs, bytes, kernel ops and vocab-axis intermediates."""
    import torch

    from repro_torch.analysis import hlo, rules

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        # first-use set-up (the BLAS workspace, the kernels' libraries)
        # allocates once a process: keep it out of the measured dispatch
        e.fn(*e.make_args(), **e.make_kwargs())
    args, kwargs = e.make_args(), e.make_kwargs()
    pool = args[e.pool_arg] if e.pool_arg is not None else None
    ptrs = rules.pool_ptrs(pool) if pool is not None else None
    if cuda:
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
    syncs, (out, tr) = rules.count_syncs(
        lambda: hlo.traced(e.fn, *args, **kwargs), dev)
    grown = None
    if cuda:
        torch.cuda.synchronize(dev)
        grown = torch.cuda.memory_allocated(dev) - before
    findings = []
    after = _returned_pool(out, pool)
    if pool is not None:
        findings += rules.check_pool_donation(after, ptrs, tr,
                                              target=e.target,
                                              grown_bytes=grown)
    if e.vocab_size is not None:
        findings += rules.check_vocab_escape(
            rules.fresh_outputs(tr.outputs, after), vocab_size=e.vocab_size,
            target=e.target)
    if e.host_budget_bytes is not None:
        findings += rules.check_host_budget(
            tr.outputs, budget_bytes=e.host_budget_bytes, pool=after,
            syncs=syncs, target=e.target)
    if e.expected_collectives is not None:
        findings += rules.check_collectives(
            tr.collectives, expected=e.expected_collectives, target=e.target)
    if e.churn is not None:
        findings += rules.check_recompile_churn(
            e.fn, e.churn.arg_makers,
            declared_buckets=e.churn.declared_buckets, target=e.target)
    census = rules.census_vocab_intermediates(
        tr, vocab_size=e.vocab_size) if e.vocab_size else []
    a = hlo.analyze(tr)
    if stats is not None:
        runs = 1 + int(cuda) + (len(e.churn.arg_makers) if e.churn else 0)
        stats.update(runs=runs, syncs=syncs, ops=len(tr.ops),
                     flops=a["flops"],
                     bytes=a["bytes"], kernels=a["kernels"],
                     vocab_intermediates=census, grown_bytes=grown)
    if verbose:
        print(f"[pass1] {e.target}: {len(tr.ops)} ops, {a['flops']:.0f} "
              f"FLOPs, {a['bytes']:.0f} B, kernels {a['kernels']}, syncs "
              f"{syncs}, vocab-axis intermediates {census}",
              file=sys.stderr)
    return findings


def audit_graphs(kv_shards: int, device, verbose: bool = False,
                 stats=None) -> list:
    """The captured dispatches of a ``ModelBackend`` on the audit model at
    ``kv_shards``: HLO005 over the graphs its decode path captures for raw
    batches 1..4 (at most 3), then one replay of each dispatch kind
    (decode, chunked prefill, wave prefill) held to HLO001 (the pool in
    place; on the card no growth of ``memory_allocated``) and HLO003
    (``8·B·c`` bytes out of a decode, ``8·B`` out of a prefill; on the
    card no host sync).  The card captures CUDA graphs; elsewhere the
    stand-in capturer (``RerunCapturer``) replays.  At one shard it also
    audits a recurrent-slot backend (:func:`audit_slot_graphs`).
    ``stats``, when given, receives each replay's syncs and bytes grown and
    the graphs captured (the slot backend's under ``"slot"``)."""
    import numpy as np
    import torch

    from repro_torch.analysis import rules
    from repro_torch.analysis.inventory import (AUDIT_ARCH, AUDIT_B, AUDIT_C,
                                                AUDIT_T)
    from repro_torch.launch.mesh import make_kv_mesh
    from repro_torch.models import ArchConfig, build_model
    from repro_torch.serving import ModelBackend
    from repro_torch.serving.graphs import RerunCapturer

    dev = torch.empty(0, device=device).device
    cuda = dev.type == "cuda"
    S = kv_shards
    model = build_model(ArchConfig(**AUDIT_ARCH))
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    be = ModelBackend(model, params, n_slots=8, max_len=64, kv_shards=S,
                      device=dev, kv_mesh=make_kv_mesh(S, devices=[dev] * S)
                      if S > 1 else None,
                      graphs=True if cuda else RerunCapturer())
    target = f"graphs@kv{S}"
    B, c, T = AUDIT_B, AUDIT_C, AUDIT_T
    rids = list(range(4))
    for r in rids:
        be.kv.allocate(r, T)

    def window(b):
        z = np.zeros(b, np.int64)
        be._dispatch_window(rids[:b], np.zeros((b, c), np.int64), z,
                            np.full(b, c, np.int64), z)

    findings = rules.check_graph_churn(be.graphs, window, (1, 2, 3, 4),
                                       declared_buckets=3, target=target)
    i64 = np.int64
    tables = np.asarray(be.kv.batch_tables(rids[:B], be._table_width),
                        np.int32)
    so = be._shard_offs(rids[:B], B)
    kinds = {
        "decode": (be._decode, 8 * B * c, dict(
            toks=np.zeros((B, c), i64), start=np.full(B, T, i64),
            valid=np.full(B, c, i64), tables=tables,
            n_adv=np.zeros(B, i64), **so)),
        "chunk": (be._chunk, 8 * B, dict(
            toks=np.zeros((B, T), i64), offs=np.zeros(B, i64),
            valid=np.full(B, T, i64), tables=tables, **so)),
        "wave": (be._wave, 8 * B, dict(
            toks=np.zeros((B, T), i64), lens=np.full(B, T, np.int32),
            tables=tables)),
    }
    readings = {}
    for kind, (fn, budget, host) in kinds.items():
        be._dispatch(kind, fn, **host)          # captured at first use
        n = len(be.graphs.entries)
        ptrs = rules.pool_ptrs(be.kv)
        if cuda:
            torch.cuda.synchronize(dev)
            before = torch.cuda.memory_allocated(dev)
        syncs, out = rules.count_syncs(
            lambda: be._dispatch(kind, fn, **host), dev)
        grown = None
        if cuda:
            torch.cuda.synchronize(dev)
            grown = torch.cuda.memory_allocated(dev) - before
        if len(be.graphs.entries) != n:
            raise RuntimeError(f"{target} {kind}: the audited call captured "
                               f"a graph instead of replaying one")
        what = f"{target}:{kind}"
        findings += rules.check_pool_donation(be.kv, ptrs, target=what,
                                              grown_bytes=grown)
        findings += rules.check_host_budget(list(out), budget_bytes=budget,
                                            pool=be.kv, syncs=syncs,
                                            target=what)
        readings[kind] = {"syncs": syncs, "grown_bytes": grown}
    if stats is not None:
        stats.update(replays=readings, graphs=len(be.graphs.entries))
    if verbose:
        print(f"[pass1] {target}: {len(be.graphs.entries)} graphs, "
              f"replays {readings}", file=sys.stderr)
    if S == 1:                          # the slot path has no sharded pool
        slot = {} if stats is not None else None
        findings += audit_slot_graphs(dev, verbose=verbose, stats=slot)
        if stats is not None:
            stats["slot"] = slot
    return findings


# the advance lengths the slot audit drives (T 2 twice: its second call
# replays)
SLOT_ADVANCE_T = (1, 2, 3, 2)


def audit_slot_graphs(device, verbose: bool = False, stats=None) -> list:
    """The captured slot dispatches of a recurrent-slot ``ModelBackend`` on
    the hybrid audit model: HLO005 in slot form over two admissions into
    two slots with two prompt lengths, two windows and advances at
    ``SLOT_ADVANCE_T`` (at most 2 graphs + one a distinct advance length:
    one ``slot_prefill``, one ``window``), then one more replay of each
    kind held to HLO001 (the slot cache in place; on the card no growth of
    ``memory_allocated``) and, on the card, to HLO003's no-sync half.
    ``stats``, when given, receives each replay's syncs and bytes grown and
    the graphs by kind."""
    import numpy as np
    import torch

    from repro_torch.analysis import rules
    from repro_torch.analysis.inventory import AUDIT_SLOT_ARCH
    from repro_torch.models import ArchConfig, build_model
    from repro_torch.serving import ModelBackend, Request
    from repro_torch.serving.backends import _slot_tensors
    from repro_torch.serving.graphs import RerunCapturer

    dev = torch.empty(0, device=device).device
    cuda = dev.type == "cuda"
    cfg = ArchConfig(**AUDIT_SLOT_ARCH)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    be = ModelBackend(model, params, n_slots=4, max_len=32, device=dev,
                      graphs=True if cuda else RerunCapturer())
    target = "graphs@slot"
    c, V, B = cfg.block_size, cfg.vocab_size, be.n_slots
    rng = np.random.default_rng(0)
    for rid, n in enumerate((5, 11)):
        be.admit(Request(rid=rid, arrival_time=0.0, prompt_len=n,
                         max_new_tokens=8,
                         prompt_tokens=rng.integers(4, V, n).tolist()))
    mask = np.zeros(B, bool)
    mask[list(be._slot_of.values())] = True

    def window():
        start = np.where(mask, be.cache["len"].cpu().numpy(), 0)
        return dict(toks=rng.integers(4, V, (B, c)), start=start,
                    valid=np.where(mask, c, 0))

    def advance(T):
        return dict(toks=rng.integers(4, V, (B, T)),
                    lens=np.where(mask, T, 0).astype(np.int32), mask=mask)

    # the audited admission re-prefills the second request's slot with
    # another length: a replay, even were the key to hold the slot
    kinds = {"slot_prefill": (be._slot_prefill, lambda: dict(
                 toks=np.zeros(be.max_len, np.int64),
                 lens=np.array([7], np.int32),
                 slot=np.array([be._slot_of[1]], np.int64))),
             "window": (be._window, window),
             "advance": (be._advance, lambda: advance(2))}
    be._dispatch("window", be._window, **window())
    be._dispatch("window", be._window, **window())
    for T in SLOT_ADVANCE_T:
        be._dispatch("advance", be._advance, **advance(T))
    n = len(be.graphs.entries)
    findings = rules.check_slot_graph_churn(be.graphs, SLOT_ADVANCE_T,
                                            target=target)
    readings = {}
    for kind, (fn, host) in kinds.items():
        args = host()
        ptrs = rules.pool_ptrs(_slot_tensors(be.cache))
        if cuda:
            torch.cuda.synchronize(dev)
            before = torch.cuda.memory_allocated(dev)
        syncs, _ = rules.count_syncs(
            lambda: be._dispatch(kind, fn, **args), dev)
        grown = None
        if cuda:
            torch.cuda.synchronize(dev)
            grown = torch.cuda.memory_allocated(dev) - before
        if len(be.graphs.entries) != n:
            raise RuntimeError(f"{target} {kind}: the audited call captured "
                               f"a graph instead of replaying one")
        what = f"{target}:{kind}"
        findings += rules.check_pool_donation(_slot_tensors(be.cache), ptrs,
                                              target=what, grown_bytes=grown)
        # HLO003's byte bound does not apply: a slot dispatch returns its
        # [n_slots, T, V] fp32 logits for the host to sample, as the
        # reference does (it counts no host bytes in this mode); only the
        # no-sync half holds
        findings += rules.check_host_budget([], budget_bytes=0, syncs=syncs,
                                            target=what)
        readings[kind] = {"syncs": syncs, "grown_bytes": grown}
    if stats is not None:
        graphs = {}
        for key in be.graphs.entries:
            graphs[key[0]] = graphs.get(key[0], 0) + 1
        stats.update(replays=readings, graphs=graphs,
                     replayed=be.graphs.replays)
    if verbose:
        print(f"[pass1] {target}: {n} graphs, replays {readings}",
              file=sys.stderr)
    return findings


def run_pass1(kv_shards_list, device="cuda", verbose=False) -> list:
    """Dispatch audit over the inventory, on ``device``."""
    import torch

    from repro_torch.analysis.inventory import (audit_registration,
                                                build_entries)

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is visible (pass "
                           "--device cpu to audit on the CPU)")
    findings = list(audit_registration())
    for shards in kv_shards_list:
        for e in build_entries(shards, device=device):
            findings += audit_entry(e, device, verbose=verbose)
        findings += audit_graphs(shards, device, verbose=verbose)
    return findings


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.check",
        description="serving-invariant static analyzer (op-trace dispatch "
                    "audit + AST repo lint)")
    p.add_argument("--json", metavar="FILE", default=None,
                   help="write structured findings (active + waived)")
    p.add_argument("--only", choices=["hlo", "lint"], default=None,
                   help="run a single pass")
    p.add_argument("--kv-shards", default="1,2",
                   help="comma list of shard counts to audit (default 1,2)")
    p.add_argument("--allowlist", default=DEFAULT_ALLOWLIST,
                   help="per-rule allowlist file")
    p.add_argument("--device", default="cuda",
                   help="where Pass 1 runs the dispatches (default cuda)")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)

    findings = []
    if args.only in (None, "lint"):
        findings += lint.run_all()
    if args.only in (None, "hlo"):
        shards = [int(s) for s in args.kv_shards.split(",") if s]
        findings += run_pass1(shards, device=args.device,
                              verbose=args.verbose)

    allowlist = load_allowlist(args.allowlist) if args.allowlist else []
    active, waived = apply_allowlist(findings, allowlist)

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"active": [x.to_dict() for x in active],
                       "waived": [x.to_dict() for x in waived]},
                      f, indent=1)
    for x in waived:
        print(f"  waived {x.rule} {x.target}")
    for x in active:
        print(f"FINDING {x.rule} {x.target}\n    {x.message}")
    print(f"{len(active)} active finding(s), {len(waived)} waived")
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
