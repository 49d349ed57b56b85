"""Serving-invariant static analyzer CLI.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis.check [--json FILE]
        [--only hlo|lint] [--kv-shards 1,2] [--allowlist FILE]
        [--device cuda|cpu] [--verbose]

Runs both passes — the dispatch audit over the dispatch inventory (Pass
1, on ``--device``: the card by default, which raises without one) and the
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
