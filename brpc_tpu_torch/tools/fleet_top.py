"""fleet_top — fleet-wide per-tenant SLO view over naming://; port of
tools/fleet_top.py over the port's `rpc/naming.py` and `rpc/observe.py`.
Host-only.

Resolves the fleet's membership from a naming registry (Naming.Stats),
pulls every live node's published digest+SLO blob (the digest-wire 2
payload each node's Announcer attaches under `trpc_fleet_publish`),
merges the latency digests octave-wise in Python, and renders one table:
per tenant, fleet-wide rate / p50 / p99 / error rate / error-budget
remaining / burn rates, plus how many nodes carry the tenant and how
many are currently breaching.

Percentiles come from a rank walk over the POOLED octave samples
(observe.digest_percentile_us — the same arithmetic as the native
recorder), never from averaging per-node p99s, so the fleet p99 matches
a single recorder that saw all the traffic within one octave (2x).
Burn rates are likewise recomputed from the SUMMED window counters: the
fleet burns its error budget as one pool.

Usage:
  python -m brpc_tpu_torch.tools.fleet_top 127.0.0.1:8000      # one shot
  python -m brpc_tpu_torch.tools.fleet_top 127.0.0.1:8000 --service fleet
  python -m brpc_tpu_torch.tools.fleet_top 127.0.0.1:8000 --watch 2
  python -m brpc_tpu_torch.tools.fleet_top 127.0.0.1:8000 --json

The --json body has the same shape as the /fleet builtin
(cpp/net/naming.cc fleet_dump_json), so consumers can switch between
pulling from any fleet member's HTTP port and merging client-side here.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from brpc_tpu_torch.rpc import observe
from brpc_tpu_torch.rpc.naming import NamingClient, NamingMissError


def fleet_view(registry: str, service: str,
               timeout_ms: int = 2000) -> dict:
    """Pull + merge: the /fleet builtin's JSON shape, computed
    client-side from Naming.Stats payloads."""
    nc = NamingClient(registry, timeout_ms=timeout_ms)
    try:
        try:
            version, records = nc.stats(service)
        except NamingMissError:
            return {"service": service, "error": "naming-miss",
                    "nodes": [], "tenants": []}
    finally:
        nc.close()

    nodes = []
    aggs: dict[str, dict] = {}
    for r in records:
        blob = None
        if r.payload:
            try:
                blob = observe.fleet_blob_decode(r.payload)
            except ValueError:
                blob = None
        nodes.append({"addr": r.member.addr, "zone": r.member.zone,
                      "epoch": r.member.epoch, "age_ms": r.age_ms,
                      "published": blob is not None})
        if blob is None:
            continue
        for t in blob["tenants"]:
            a = aggs.setdefault(t["tenant"], {
                "digest": observe.Digest(),
                "p99_target_us": None, "avail_target": 0.0,
                "fast_total": 0, "fast_bad": 0, "fast_err": 0,
                "slow_total": 0, "slow_bad": 0, "slow_err": 0,
                "nodes": 0, "breached_nodes": 0,
            })
            observe.digest_merge(a["digest"], t["digest"])
            if t["p99_target_us"] is not None:
                a["p99_target_us"] = (
                    t["p99_target_us"] if a["p99_target_us"] is None
                    else min(a["p99_target_us"], t["p99_target_us"]))
            a["avail_target"] = max(a["avail_target"], t["avail_target"])
            for k in ("fast_total", "fast_bad", "fast_err",
                      "slow_total", "slow_bad", "slow_err"):
                a[k] += t[k]
            a["nodes"] += 1
            a["breached_nodes"] += 1 if t["breached"] else 0

    tenants = []
    for name in sorted(aggs):
        a = aggs[name]
        d = a["digest"]
        allowed = max(1.0 - a["avail_target"], 1e-6)
        burn_fast = ((a["fast_bad"] / a["fast_total"]) / allowed
                     if a["fast_total"] > 0 else 0.0)
        burn_slow = ((a["slow_bad"] / a["slow_total"]) / allowed
                     if a["slow_total"] > 0 else 0.0)
        tenants.append({
            "tenant": name,
            "nodes": a["nodes"],
            "breached_nodes": a["breached_nodes"],
            "p99_target_us": (-1 if a["p99_target_us"] is None
                              else a["p99_target_us"]),
            "avail_target": a["avail_target"],
            "rate": d.qps,
            "p50_us": observe.digest_percentile_us(d, 0.5),
            "p99_us": observe.digest_percentile_us(d, 0.99),
            "avg_us": d.avg_us,
            "count": d.count,
            "error_rate": (a["slow_err"] / a["slow_total"]
                           if a["slow_total"] > 0 else 0.0),
            "burn_fast": burn_fast,
            "burn_slow": burn_slow,
            "budget_remaining": max(0.0, min(1.0, 1.0 - burn_slow)),
        })
    return {"service": service, "version": version,
            "nodes": nodes, "tenants": tenants}


def render(view: dict) -> str:
    lines = []
    live = [n for n in view["nodes"] if n.get("published")]
    lines.append(
        f"fleet {view['service']!r}: {len(view['nodes'])} node(s), "
        f"{len(live)} publishing"
        + (f"  [{view['error']}]" if view.get("error") else ""))
    for n in view["nodes"]:
        mark = "+" if n["published"] else "-"
        lines.append(f"  {mark} {n['addr']:<21} zone={n['zone'] or '-':<8} "
                     f"age_ms={n['age_ms']}")
    if not view["tenants"]:
        lines.append("  (no tenant publications)")
        return "\n".join(lines)
    hdr = (f"{'TENANT':<16} {'NODES':>5} {'RATE':>8} {'P50us':>8} "
           f"{'P99us':>9} {'TGTus':>8} {'ERR%':>6} {'BUDGET':>7} "
           f"{'BURNf':>7} {'BURNs':>7} {'BRCH':>4}")
    lines.append(hdr)
    for t in view["tenants"]:
        tgt = "-" if t["p99_target_us"] < 0 else str(t["p99_target_us"])
        lines.append(
            f"{t['tenant']:<16} {t['nodes']:>5} {t['rate']:>8.1f} "
            f"{t['p50_us']:>8} {t['p99_us']:>9} {tgt:>8} "
            f"{t['error_rate'] * 100:>6.2f} "
            f"{t['budget_remaining'] * 100:>6.1f}% "
            f"{t['burn_fast']:>7.2f} {t['burn_slow']:>7.2f} "
            f"{t['breached_nodes']:>4}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("registry", help="naming registry host:port")
    ap.add_argument("--service", default="fleet",
                    help="announced service name (default: fleet)")
    ap.add_argument("--json", action="store_true",
                    help="emit the merged view as JSON and exit")
    ap.add_argument("--watch", type=float, default=0.0, metavar="SECS",
                    help="refresh every SECS seconds until interrupted")
    ap.add_argument("--timeout-ms", type=int, default=2000)
    args = ap.parse_args(argv)

    while True:
        view = fleet_view(args.registry, args.service, args.timeout_ms)
        if args.json:
            print(json.dumps(view, indent=2))
        else:
            print(render(view))
        if args.watch <= 0:
            break
        time.sleep(args.watch)
        print()
    return 0 if not view.get("error") else 1


if __name__ == "__main__":
    sys.exit(main())
