#!/usr/bin/env python3
"""``hvd_top``: live terminal dashboard over the gang telemetry view.
The port of ``horovod_tpu/tools/hvd_top.py`` (standard library only).

Fetches ``GET /gang/metrics.json`` from the rank-0 debug server (the
gang aggregator's latest fold, ``horovod_tpu_torch/telemetry/aggregate.py``,
whose view a JAX gang's aggregator writes the same way) and renders one
row per rank — interval step rate, collective p50/p99, straggler skew,
cumulative transport bytes, queue depth, and any anomaly alerts naming
the rank — refreshing in place like ``top``.

Usage::

    hvd-top-torch [--addr HOST:PORT] [--interval S]
    hvd-top-torch --once [--json]   # one fetch; --json emits the raw view

``--addr`` defaults to ``127.0.0.1:$HVD_METRICS_PORT`` (the coordinator
binds ``HVD_METRICS_PORT + local_rank``, and rank 0 is local rank 0 on
its host).  ``--once --json`` prints exactly the aggregator's view, so
scripts see the same document the fleet router reads from the KV mirror
(``gang/metrics``).

Routing a "training suddenly slow" report: run ``hvd_top``, read the
ALERTS column (throughput_collapse / straggler_skew name the rank), then
``hvd_trace analyze`` that rank's span file for the phase breakdown —
see docs/troubleshooting.md.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.request

_CLEAR = "\x1b[2J\x1b[H"


def default_addr() -> str:
    port = os.environ.get("HVD_METRICS_PORT", "")
    return f"127.0.0.1:{port}" if port else "127.0.0.1:9090"


def fetch(addr: str, timeout: float = 2.0) -> dict:
    """The aggregator's current gang view (raises on unreachable/404)."""
    base = addr if "://" in addr else f"http://{addr}"
    with urllib.request.urlopen(f"{base}/gang/metrics.json",
                                timeout=timeout) as resp:
        view = json.loads(resp.read().decode("utf-8"))
    if not isinstance(view, dict):
        raise ValueError(f"unexpected gang view from {addr}")
    return view


def render(view: dict) -> str:
    """The dashboard as one printable string (tested without a tty)."""
    lines = []
    alerts = view.get("alerts", [])
    stale = view.get("stale_ranks", [])
    status = "ALERTING" if alerts else ("DEGRADED" if stale else "ok")
    lines.append(
        f"hvd_top — gang of {view.get('size', '?')} "
        f"(epoch {view.get('epoch', 0)}, fold #{view.get('seq', 0)}) "
        f"status: {status}")
    if stale:
        lines.append(f"  stale ranks: {stale}")
    for a in alerts:
        lines.append(
            f"  ALERT {a.get('rule')}: rank {a.get('rank')} "
            f"value={a.get('value')} baseline={a.get('baseline')} "
            f"(since fold #{a.get('since_seq')})")
    lines.append("")
    lines.append(f"{'RANK':>4} {'STEP/S':>8} {'P50ms':>8} {'P99ms':>8} "
                 f"{'SKEWms':>8} {'XPORT MB':>10} {'QUEUE':>6}  ALERTS")
    for row in view.get("per_rank", []):
        if row.get("stale"):
            lines.append(f"{row['rank']:>4} {'—  stale (no snapshot)':>46}")
            continue
        lines.append(
            f"{row['rank']:>4} {row['step_rate']:>8.2f} "
            f"{row['coll_p50_ms']:>8.2f} {row['coll_p99_ms']:>8.2f} "
            f"{row['skew_ms']:>8.2f} {row['transport_mb']:>10.2f} "
            f"{row['queue']:>6}  {','.join(row.get('alerts', [])) or '-'}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--addr", default=default_addr(),
                    help="rank-0 debug server (default: "
                         "127.0.0.1:$HVD_METRICS_PORT)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh period in seconds (default 2)")
    ap.add_argument("--once", action="store_true",
                    help="render one fetch and exit")
    ap.add_argument("--json", action="store_true",
                    help="with --once: print the raw gang view JSON")
    args = ap.parse_args(argv)

    if args.once:
        try:
            view = fetch(args.addr)
        except Exception as e:
            print(f"hvd_top: no gang view at {args.addr}: {e}",
                  file=sys.stderr)
            return 1
        if args.json:
            json.dump(view, sys.stdout, sort_keys=True)
            print()
        else:
            print(render(view))
        return 0

    while True:
        try:
            body = render(fetch(args.addr))
        except KeyboardInterrupt:
            return 0
        except Exception as e:
            body = f"hvd_top: waiting for gang view at {args.addr} ({e})"
        sys.stdout.write(_CLEAR + body + "\n")
        sys.stdout.flush()
        try:
            time.sleep(max(0.2, args.interval))
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    raise SystemExit(main())
