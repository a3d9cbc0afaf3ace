#!/usr/bin/env python3
"""Gang-correlated postmortem over flight-recorder dumps: the port of
``horovod_tpu/tools/hvd_postmortem.py`` (standard library only), the
``hvd-postmortem-torch`` script.

Input is a directory of ``blackbox_rank<r>.json`` dumps (plus the
coordinator-pulled ``blackbox_rank<r>.pulled.json`` copies) written by
``horovod_tpu_torch/telemetry/blackbox.py`` (or a JAX rank's, in the same
format) at a terminal failure — the always-on
black box every rank carries (docs/fault_tolerance.md "the black box",
docs/troubleshooting.md "Postmortem workflow").

The verdict names the **first-cause rank**: the rank the rest of the
gang was blocked on, resolved in precedence order:

1. The gang's own ruling — ranks named by ``abort.verdict`` / ``evict``
   events and terminal dump reasons (``evicted``), majority across
   dumps.  The abort agreement already did the hard work; trust it.
2. The most-blamed peer across the survivors' ``collective.timeout``
   blame edges (who each rank was blocked on when its deadline fired).
3. The earliest-silent rank: after aligning each dump's events onto
   rank 0's clock axis (the per-dump midpoint-method offset estimate,
   the trace's clock-sync machinery), the rank whose last recorded event is oldest.

What the culprit was doing (phase / peer / seq / collective name) comes
from its own dump when one exists — the coordinator pull fetches a
wedged rank's ring over the still-live control channel even while its
background thread hangs — and from the survivors' blame edges when the
rank died without a trace (SIGKILL).

Usage::

    hvd-postmortem-torch <dump_dir> [--json]
    python -m horovod_tpu_torch.tools.hvd_postmortem <dump_dir> [--json]

Importable: :func:`analyze` returns the verdict as a dict;
tests/test_torch_tools.py holds it to the JAX package's on the same
dumps.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import Dict, List, Optional

_NAME_RE = re.compile(r"blackbox_rank(\d+)(\.pulled)?\.json$")

# Dump reasons that mark the dumping rank itself as the failure (vs.
# reasons a healthy survivor records on its way down).
_SELF_FAULT_REASONS = ("evicted",)


# -- loading ------------------------------------------------------------


def load_dump(path: str) -> Optional[dict]:
    """One dump document, or None when torn/corrupt (a crash mid-write
    never happens for the atomic direct dumps, but a pulled copy can
    lose its sender mid-frame)."""
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or "rank" not in doc:
        return None
    doc["_path"] = path
    doc["_pulled"] = path.endswith(".pulled.json")
    return doc


def dump_files(d: str) -> List[str]:
    out = [p for p in glob.glob(os.path.join(d, "blackbox_rank*.json"))
           if _NAME_RE.search(os.path.basename(p))]
    return sorted(out)


def load_dir(d: str) -> Dict[int, dict]:
    """rank -> dump, preferring a rank's own atomic dump over the
    coordinator-pulled copy (the pull races the direct write; the
    direct file is the complete, reason-stamped document)."""
    by_rank: Dict[int, dict] = {}
    for p in dump_files(d):
        doc = load_dump(p)
        if doc is None:
            continue
        r = int(doc["rank"])
        have = by_rank.get(r)
        if have is None or (have["_pulled"] and not doc["_pulled"]):
            by_rank[r] = doc
    return by_rank


# -- correlation --------------------------------------------------------


def _aligned_last_event_ns(doc: dict) -> int:
    """The dump's newest timed event on rank 0's clock axis (0 = the
    ring holds no timed events)."""
    off = int(doc.get("clock_offset_ns", 0) or 0)
    last = 0
    for ev in doc.get("events", []):
        t = int(ev.get("t_ns", 0) or 0)
        if t:
            last = max(last, t + off)
    return last


def _named_by_gang(dumps: Dict[int, dict]) -> List[int]:
    """Ranks the gang itself ruled against: abort-verdict / evict events
    (majority across dumps) plus any rank whose own dump reason is a
    self-fault (``evicted``)."""
    votes: Dict[int, int] = {}
    for doc in dumps.values():
        named = set()
        for ev in doc.get("events", []):
            if ev.get("kind") in ("abort.verdict", "evict",
                                  "heartbeat.miss", "leader.failover",
                                  "replica.divergence"):
                for r in ev.get("ranks", []) or (
                        [ev["rank"]] if "rank" in ev else []):
                    named.add(int(r))
        for r in named:
            votes[r] = votes.get(r, 0) + 1
    quorum = max(1, (len(dumps) + 1) // 2)
    ruled = sorted(r for r, n in votes.items() if n >= quorum)
    for r, doc in dumps.items():
        if doc.get("reason") in _SELF_FAULT_REASONS and r not in ruled:
            ruled.append(r)
    return sorted(ruled)


def _most_blamed(dumps: Dict[int, dict]) -> Optional[int]:
    """The peer most often named in ``collective.timeout`` blame edges;
    ties go to the lowest rank (same rule the coordinator uses)."""
    blame: Dict[int, int] = {}
    for doc in dumps.values():
        for ev in doc.get("events", []):
            if ev.get("kind") == "collective.timeout":
                peer = int(ev.get("peer", -1))
                if peer >= 0:
                    blame[peer] = blame.get(peer, 0) + 1
    if not blame:
        return None
    top = max(blame.values())
    return min(r for r, n in blame.items() if n == top)


def _earliest_silent(dumps: Dict[int, dict]) -> Optional[int]:
    """The rank that went quiet first on the aligned axis."""
    last: Dict[int, int] = {}
    for r, doc in dumps.items():
        t = _aligned_last_event_ns(doc)
        if t:
            last[r] = t
    if not last:
        return None
    lo = min(last.values())
    return min(r for r, t in last.items() if t == lo)


def _doing(doc: Optional[dict]) -> dict:
    """What a rank was doing per its own dump: the in-flight collective
    (name + begin fields) or its last ``collective.begin``."""
    out = {"name": "", "phase": "", "peer": -1, "seq": -1, "op": ""}
    if doc is None:
        return out
    inf = doc.get("in_flight")
    if isinstance(inf, dict) and inf.get("name"):
        out["name"] = str(inf["name"])
        out["phase"] = "collective"
    for ev in reversed(doc.get("events", [])):
        if ev.get("kind") == "collective.begin" and (
                not out["name"] or ev.get("name") == out["name"]):
            out["name"] = out["name"] or str(ev.get("name", ""))
            out["peer"] = int(ev.get("peer", -1))
            out["seq"] = int(ev.get("seq", -1))
            out["op"] = str(ev.get("op", ""))
            out["phase"] = out["phase"] or "collective"
            break
    return out


def _blamed_doing(dumps: Dict[int, dict], culprit: int) -> dict:
    """Culprit context reconstructed from the survivors' blame edges —
    the fallback when the culprit died without a dump (SIGKILL)."""
    out = {"name": "", "phase": "", "peer": -1, "seq": -1, "op": ""}
    for doc in dumps.values():
        for ev in doc.get("events", []):
            if ev.get("kind") == "collective.timeout" and \
                    int(ev.get("peer", -1)) == culprit:
                out["name"] = str(ev.get("name", ""))
                out["phase"] = str(ev.get("phase", ""))
                return out
    return out


def analyze(d: str) -> Optional[dict]:
    """The gang-correlated verdict for one dump directory, or None when
    it holds no loadable dumps."""
    dumps = load_dir(d)
    if not dumps:
        return None

    ruled = _named_by_gang(dumps)
    blamed = _most_blamed(dumps)
    silent = _earliest_silent(dumps)
    evidence: List[str] = []
    if ruled:
        first_cause = ruled[0]
        evidence.append(
            f"gang ruling: rank(s) {ruled} named by abort/evict "
            f"events across {len(dumps)} dump(s)")
    elif blamed is not None:
        first_cause = blamed
        evidence.append(
            f"blame edges: rank {blamed} is the most-blamed peer in "
            f"collective.timeout records")
    elif silent is not None:
        first_cause = silent
        evidence.append(
            f"clock-aligned silence: rank {silent} stopped recording "
            f"first")
    else:
        first_cause = min(dumps)
        evidence.append(
            "no failure events recorded; defaulting to the lowest "
            "dumped rank")
    if blamed is not None and blamed != first_cause:
        evidence.append(
            f"note: blame edges point at rank {blamed} as well")
    if silent is not None:
        evidence.append(
            f"last aligned activity: rank {silent} is earliest-silent")

    culprit_doc = dumps.get(first_cause)
    doing = _doing(culprit_doc)
    if not doing["name"]:
        doing = _blamed_doing(dumps, first_cause)
    if culprit_doc is None:
        evidence.append(
            f"rank {first_cause} left no dump (died hard); context "
            f"reconstructed from survivors' blame edges")
    elif culprit_doc["_pulled"]:
        evidence.append(
            f"rank {first_cause}'s ring was pulled over the control "
            f"channel by the coordinator (its own dump never landed)")

    ranks = {}
    for r, doc in sorted(dumps.items()):
        blocked = _doing(doc)
        timeout_ev = next(
            (ev for ev in reversed(doc.get("events", []))
             if ev.get("kind") == "collective.timeout"), None)
        if timeout_ev is not None:
            blocked["peer"] = int(timeout_ev.get("peer", blocked["peer"]))
            blocked["phase"] = str(timeout_ev.get("phase",
                                                  blocked["phase"]))
        ranks[r] = {
            "reason": doc.get("reason", ""),
            "pulled": doc["_pulled"],
            "epoch": doc.get("epoch", 0),
            "clock_offset_ns": int(doc.get("clock_offset_ns", 0) or 0),
            "events": len(doc.get("events", [])),
            "blocked_on": blocked,
        }

    return {
        "dir": d,
        "dumped_ranks": sorted(dumps),
        "first_cause": first_cause,
        "doing": doing,
        "gang_ruled": ruled,
        "most_blamed": blamed,
        "earliest_silent": silent,
        "evidence": evidence,
        "ranks": ranks,
    }


# -- CLI ----------------------------------------------------------------


def _print_verdict(v: dict) -> None:
    doing = v["doing"]
    what = doing["name"] or "<unknown collective>"
    extra = []
    if doing["phase"]:
        extra.append(f"phase={doing['phase']}")
    if doing["peer"] >= 0:
        extra.append(f"peer={doing['peer']}")
    if doing["seq"] >= 0:
        extra.append(f"seq={doing['seq']}")
    if doing["op"]:
        extra.append(f"op={doing['op']}")
    print(f"postmortem: {v['dir']}")
    print(f"  first cause: rank {v['first_cause']} — {what}"
          + (f" ({', '.join(extra)})" if extra else ""))
    print("  evidence:")
    for line in v["evidence"]:
        print(f"    - {line}")
    print("  per-rank state at dump time:")
    for r, info in sorted(v["ranks"].items()):
        b = info["blocked_on"]
        on = (f"blocked on peer {b['peer']} in {b['name'] or '<idle>'}"
              if b["peer"] >= 0 else
              (f"in {b['name']}" if b["name"] else "idle"))
        src = "pulled" if info["pulled"] else "direct"
        print(f"    rank {r}: reason={info['reason'] or '-'} {on} "
              f"[{info['events']} events, {src} dump, "
              f"offset {info['clock_offset_ns']} ns]")
    missing = [r for r in range(max(v["ranks"]) + 1)
               if r not in v["ranks"]]
    if missing:
        print(f"  no dump from rank(s) {missing} "
              "(died before dumping and the pull found nothing)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("dump_dir", help="directory of blackbox_rank*.json")
    ap.add_argument("--json", action="store_true",
                    help="emit the verdict as JSON instead of text")
    args = ap.parse_args(argv)
    v = analyze(args.dump_dir)
    if v is None:
        print(f"hvd_postmortem: no loadable blackbox_rank*.json in "
              f"{args.dump_dir}", file=sys.stderr)
        return 1
    if args.json:
        json.dump(v, sys.stdout, indent=2, sort_keys=True)
        print()
    else:
        _print_verdict(v)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
