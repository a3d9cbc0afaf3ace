#!/usr/bin/env python3
"""Merge, analyze, and diff gang-wide trace files: the port of
``horovod_tpu/tools/hvd_trace.py`` (standard library only), the
``hvd-trace-torch`` script.

Input is the per-rank JSONL span streams written by
``horovod_tpu_torch/telemetry/trace.py`` (or a JAX rank's
``horovod_tpu/telemetry/trace.py``: the records are the same;
``HVD_TRACE=1``; one
``trace_rank<R>.jsonl`` per rank under ``HVD_TRACE_DIR``).  See
docs/timeline.md "Gang-wide tracing" for the workflow.

Subcommands:

* ``merge <out.json> <trace_rank*.jsonl ...>`` — align every rank's
  monotonic clock onto rank 0's axis (median of the midpoint-method
  ``clock`` records; wall-anchor fallback when a stream carries none)
  and fuse the streams into one Chrome/Perfetto ``traceEvents`` JSON —
  load it at https://ui.perfetto.dev or chrome://tracing.
* ``analyze <trace_rank*.jsonl ...>`` — per-collective critical path:
  for each fused collective (grouped by ``seq``, identical on every
  rank), which (rank, phase, hop) span bounded it, plus a mean
  per-phase breakdown across the run.
* ``diff <base> <new>`` — attribute a regression between two traced
  runs (directories of rank files, or two ``analyze --json`` outputs)
  to specific phases: prints the top phase deltas.

Importable: :func:`analyze_dir` gives a run's phase breakdown (the
port's ``chip_smoke.py`` reads its telemetry phase's trace files with
it), and :func:`top_deltas` names the phases that moved between two
runs.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import Dict, List, Optional

# Span phases that belong to a fused collective's execution window and
# compete for its critical path (negotiate overlaps the previous
# collective, callback is serial bookkeeping — both reported in the
# breakdown, but hop/pack/unpack are what bound the data plane).
_CRITICAL_PHASES = ("hop", "pack", "unpack")
_BREAKDOWN_PHASES = ("negotiate", "pack", "hop.recv", "hop.reduce",
                     "hop.send_wait", "unpack", "callback")


# -- loading ------------------------------------------------------------


def _rank_from_name(path: str) -> int:
    m = re.search(r"trace_rank(\d+)\.jsonl", os.path.basename(path))
    return int(m.group(1)) if m else -1


def load_rank_file(path: str) -> dict:
    """Parse one rank's JSONL stream.  Corrupt or truncated lines (a
    crash mid-record) are skipped — every intact record still loads."""
    meta: List[dict] = []
    clocks: List[dict] = []
    spans: List[dict] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn tail from a crash mid-write
            k = rec.get("k")
            if k == "meta":
                meta.append(rec)
            elif k == "clock":
                clocks.append(rec)
            elif k == "span":
                spans.append(rec)
    rank = meta[-1]["rank"] if meta else _rank_from_name(path)
    return {"path": path, "rank": rank, "meta": meta,
            "clocks": clocks, "spans": spans}


def trace_files(d: str) -> List[str]:
    return sorted(glob.glob(os.path.join(d, "trace_rank*.jsonl")),
                  key=_rank_from_name)


def load_files(paths: List[str]) -> List[dict]:
    return [load_rank_file(p) for p in paths]


# -- clock alignment ----------------------------------------------------


def rank_offsets(files: List[dict]) -> Dict[int, int]:
    """Per-rank offset (ns) mapping each rank's monotonic axis onto the
    reference rank's (rank 0 when present): the median of the rank's
    midpoint-method clock records.  A stream with no clock records
    falls back to the wall-anchor difference — NTP-grade, still exact
    for same-host ranks sharing one system CLOCK_MONOTONIC."""
    by_rank = {f["rank"]: f for f in files}
    ref = by_rank.get(0) or by_rank[min(by_rank)]
    offsets: Dict[int, int] = {}
    for r, f in sorted(by_rank.items()):
        if f is ref:
            offsets[r] = 0
            continue
        offs = sorted(c["offset_ns"] for c in f["clocks"])
        if offs:
            offsets[r] = offs[len(offs) // 2]
        elif f["meta"] and ref["meta"]:
            m, m0 = f["meta"][0], ref["meta"][0]
            offsets[r] = ((m["wall_anchor_ns"] - m["mono_anchor_ns"])
                          - (m0["wall_anchor_ns"] - m0["mono_anchor_ns"]))
        else:
            offsets[r] = 0
    return offsets


# -- merge --------------------------------------------------------------


def merge(files: List[dict]) -> dict:
    """Fuse per-rank streams into one Chrome/Perfetto trace: one process
    per rank, timestamps aligned onto the reference rank's clock."""
    offsets = rank_offsets(files)
    events: List[dict] = []
    for f in sorted(files, key=lambda x: x["rank"]):
        r = f["rank"]
        off = offsets[r]
        events.append({"ph": "M", "pid": r, "tid": 0,
                       "name": "process_name",
                       "args": {"name": f"rank {r}"}})
        for s in f["spans"]:
            args = {k: v for k, v in s.items()
                    if k not in ("k", "ph", "t0", "t1")}
            ts_us = (s["t0"] + off) / 1e3
            if s["t1"] == s["t0"]:
                events.append({"name": s["ph"], "ph": "i", "pid": r,
                               "tid": 0, "ts": ts_us, "s": "p",
                               "args": args})
            else:
                events.append({"name": s["ph"], "ph": "X", "pid": r,
                               "tid": 0, "ts": ts_us,
                               "dur": (s["t1"] - s["t0"]) / 1e3,
                               "args": args})
    events.sort(key=lambda e: e.get("ts", 0.0))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# -- analyze ------------------------------------------------------------


def _hop_subphase(s: dict) -> str:
    """Refine a hop span to its dominant sub-timing."""
    parts = {"hop.recv": s.get("recv_ns", 0),
             "hop.reduce": s.get("reduce_ns", 0),
             "hop.send_wait": s.get("send_wait_ns", 0)}
    return max(parts, key=parts.get)


def _stall_end_ns(s: dict, off: int) -> int:
    """Aligned time at which the span's blocking wait resolved.  For a
    hop that is the end of receive+reduce (the moment the chunk could
    leave for the next rank), not the span end — the span also covers
    the send fence, so a downstream echo can end *before* its origin."""
    if s["ph"] == "hop":
        return s["t0"] + s.get("recv_ns", 0) + s.get("reduce_ns", 0) + off
    return s["t1"] + off


def analyze(files: List[dict]) -> dict:
    """Per-collective critical path + mean per-phase breakdown.

    Collectives are grouped by ``seq`` (bumped identically on every
    rank, in response-stream order).  The critical span of a collective
    is the longest hop/pack/unpack span any rank recorded for that seq
    — the data-plane step the fused op could not finish before; hop
    spans are refined to hop.recv / hop.reduce / hop.send_wait by their
    largest sub-timing.  ``phase_breakdown_ms`` is mean milliseconds
    per collective per rank, the block a benchmark snapshot embeds."""
    offsets = rank_offsets(files)
    groups: Dict[int, list] = {}
    names: Dict[int, dict] = {}
    totals = {ph: 0.0 for ph in _BREAKDOWN_PHASES}
    for f in files:
        off = offsets[f["rank"]]
        for s in f["spans"]:
            seq = s.get("seq", -1)
            ph = s["ph"]
            if ph == "hop":
                totals["hop.recv"] += s.get("recv_ns", 0) / 1e6
                totals["hop.reduce"] += s.get("reduce_ns", 0) / 1e6
                totals["hop.send_wait"] += s.get("send_wait_ns", 0) / 1e6
            elif ph in totals:
                totals[ph] += (s["t1"] - s["t0"]) / 1e6
            if seq < 0:
                continue
            if ph == "collective":
                names.setdefault(seq, {"name": s.get("name", "?"),
                                       "op": s.get("op", "?")})
                groups.setdefault(seq, [])
            if ph in _CRITICAL_PHASES or ph == "collective":
                groups.setdefault(seq, []).append((f["rank"], off, s))
    collectives = []
    for seq in sorted(groups):
        spans = groups[seq]
        coll = [(r, off, s) for r, off, s in spans
                if s["ph"] == "collective"]
        wall_ms = 0.0
        if coll:
            wall_ms = (max(s["t1"] + off for _, off, s in coll)
                       - min(s["t0"] + off for _, off, s in coll)) / 1e6
        # Critical span: longest hop/pack/unpack span — but a stalled
        # hop *propagates*: every downstream rank blocks nearly as long
        # waiting on the late chunk, and each echo span is marginally
        # longer than the origin (it also absorbs the origin's combine
        # and wire time).  Among near-tied longest spans, the origin is
        # the one whose blocking wait RESOLVED earliest: data cannot
        # reach an echo before the origin finished receiving+reducing.
        cand = [(s["t1"] - s["t0"], r, off, s) for r, off, s in spans
                if s["ph"] in _CRITICAL_PHASES]
        crit = None
        if cand:
            dmax = max(d for d, _, _, _ in cand)
            tied = [c for c in cand if c[0] >= 0.8 * dmax]
            crit = min(tied, key=lambda c: _stall_end_ns(c[3], c[2]))
        entry = dict(seq=seq, wall_ms=round(wall_ms, 3),
                     **names.get(seq, {"name": "?", "op": "?"}))
        if crit is not None:
            dur, r, _, s = crit
            phase = _hop_subphase(s) if s["ph"] == "hop" else s["ph"]
            entry["critical"] = {
                "rank": r, "phase": phase, "dur_ms": round(dur / 1e6, 3),
                "hop": s.get("hop", -1), "peer": s.get("peer", -1),
                "ring": s.get("ring", ""), "tp": s.get("tp", "")}
        collectives.append(entry)
    n = max(1, len(collectives)) * max(1, len(files))
    breakdown = {ph: round(totals[ph] / n, 4)
                 for ph in _BREAKDOWN_PHASES}
    return {"num_ranks": len(files),
            "num_collectives": len(collectives),
            "clock_offsets_ns": {str(r): o for r, o in offsets.items()},
            "phase_breakdown_ms": breakdown,
            "collectives": collectives}


def analyze_dir(d: str) -> Optional[dict]:
    """:func:`analyze` over every rank file in a trace dir (None when
    the dir holds no trace files) — the entry point for a benchmark."""
    paths = trace_files(d)
    if not paths:
        return None
    return analyze(load_files(paths))


# -- diff ---------------------------------------------------------------


def top_deltas(old: Dict[str, float], new: Dict[str, float],
               top: int = 3) -> List[tuple]:
    """Rank phases by absolute per-collective time moved between two
    ``phase_breakdown_ms`` blocks: [(phase, old_ms, new_ms, delta_ms)],
    largest mover first."""
    rows = []
    for ph in sorted(set(old) | set(new)):
        a = float(old.get(ph, 0.0))
        b = float(new.get(ph, 0.0))
        rows.append((ph, a, b, b - a))
    rows.sort(key=lambda x: abs(x[3]), reverse=True)
    return rows[:top]


def _load_breakdown(path: str) -> Dict[str, float]:
    """A diff operand: a trace dir, a rank file, or an ``analyze
    --json`` / benchmark-snapshot JSON carrying ``phase_breakdown_ms``."""
    if os.path.isdir(path):
        rep = analyze_dir(path)
        if rep is None:
            raise SystemExit(f"no trace_rank*.jsonl under {path}")
        return rep["phase_breakdown_ms"]
    if path.endswith(".jsonl"):
        return analyze(load_files([path]))["phase_breakdown_ms"]
    with open(path) as fh:
        doc = json.load(fh)
    for key in ("phase_breakdown_ms", "phase_breakdown"):
        if key in doc:
            blk = doc[key]
            return blk.get("phase_breakdown_ms", blk) \
                if isinstance(blk, dict) and "phase_breakdown_ms" in blk \
                else blk
    raise SystemExit(f"{path}: no phase_breakdown_ms block")


# -- CLI ----------------------------------------------------------------


def _print_analysis(rep: dict) -> None:
    print(f"ranks: {rep['num_ranks']}  "
          f"collectives: {rep['num_collectives']}")
    offs = rep["clock_offsets_ns"]
    print("clock offsets vs rank 0 (us): "
          + "  ".join(f"r{r}:{int(o) / 1e3:+.1f}"
                      for r, o in sorted(offs.items(),
                                         key=lambda kv: int(kv[0]))))
    print("phase breakdown (mean ms per collective per rank):")
    for ph, ms in rep["phase_breakdown_ms"].items():
        print(f"  {ph:<14} {ms:9.4f}")
    crit_count: Dict[str, int] = {}
    for c in rep["collectives"]:
        crit = c.get("critical")
        if not crit:
            continue
        key = f"rank {crit['rank']} {crit['phase']}"
        crit_count[key] = crit_count.get(key, 0) + 1
    if crit_count:
        print("critical path (collectives bounded, by rank+phase):")
        for key, n in sorted(crit_count.items(),
                             key=lambda kv: -kv[1]):
            print(f"  {key:<24} {n}")
    slowest = sorted((c for c in rep["collectives"] if c.get("critical")),
                     key=lambda c: -c["wall_ms"])[:5]
    if slowest:
        print("slowest collectives:")
        for c in slowest:
            cr = c["critical"]
            where = f"hop {cr['hop']} peer {cr['peer']}" \
                if cr["phase"].startswith("hop") else cr["phase"]
            print(f"  seq {c['seq']:>4} {c['op']:<12} "
                  f"wall {c['wall_ms']:8.3f} ms  <- rank {cr['rank']} "
                  f"{cr['phase']} ({where}, {cr['dur_ms']:.3f} ms)")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="hvd-trace-torch",
        description="merge / analyze / diff gang-wide trace files")
    sub = ap.add_subparsers(dest="cmd", required=True)

    mp = sub.add_parser("merge", help="fuse rank files into one "
                        "Chrome/Perfetto trace JSON")
    mp.add_argument("out")
    mp.add_argument("ranks", nargs="+",
                    help="trace_rank*.jsonl files (or one trace dir)")

    an = sub.add_parser("analyze", help="critical path + phase breakdown")
    an.add_argument("ranks", nargs="+")
    an.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")

    df = sub.add_parser("diff", help="attribute a regression between two "
                        "traced runs to phases")
    df.add_argument("base", help="trace dir / rank file / analysis JSON")
    df.add_argument("new")
    df.add_argument("--top", type=int, default=3)

    args = ap.parse_args(argv)

    if args.cmd in ("merge", "analyze"):
        paths: List[str] = []
        for p in args.ranks:
            paths.extend(trace_files(p) if os.path.isdir(p) else [p])
        if not paths:
            print("no trace files", file=sys.stderr)
            return 2
        files = load_files(paths)

    if args.cmd == "merge":
        doc = merge(files)
        with open(args.out, "w") as fh:
            json.dump(doc, fh)
        print(f"wrote {args.out}: {len(doc['traceEvents'])} events "
              f"from {len(files)} rank(s)")
        return 0

    if args.cmd == "analyze":
        rep = analyze(files)
        if args.json:
            json.dump(rep, sys.stdout, indent=1)
            print()
        else:
            _print_analysis(rep)
        return 0

    # diff
    old = _load_breakdown(args.base)
    new = _load_breakdown(args.new)
    print(f"phase deltas (ms per collective per rank), top {args.top}:")
    for ph, a, b, d in top_deltas(old, new, args.top):
        pct = f" ({d / a * 100.0:+.1f}%)" if a else ""
        print(f"  {ph:<14} {a:9.4f} -> {b:9.4f}  {d:+9.4f}{pct}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
