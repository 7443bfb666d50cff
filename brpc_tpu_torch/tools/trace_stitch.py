"""Cross-node trace stitcher — port of tools/trace_stitch.py: rpcz span
sets (+ flight-recorder timelines) → ONE Chrome trace-event JSON.

The dumps are the native runtime's (the same JSON whichever package asks
for them); this process's own come from the port's `rpc/observe.py`.  The
stitching is host-only and the reference's, line for line.

Given N node endpoints and a trace_id, pulls every node's spans from
`/rpcz?format=json&trace_id=...`, joins parent/child links across hops,
and emits Chrome trace-event JSON loadable in Perfetto (ui.perfetto.dev)
or chrome://tracing: one process track per node, spans as complete
events (ph "X", server vs client on separate thread tracks), span
annotations as instant events (ph "i").

With `--timeline` each node's `/timeline` flight-recorder dump
merges into the SAME file: a thread track per worker pthread carrying
fiber run→park slices (named by the rpcz method whose span they execute
when the span_id stamped into the run event resolves), messenger sweep
and inline-response slices nested under them, scheduler instants
(create/ready/wake/steal/migrate), and synthetic per-node async tracks
for stripe rails (one per rail, chunk sends + lifecycle) and QoS lanes
(DRR drain rounds).  Spans and timeline events join exactly: every event
carries the emitting fiber's ambient trace/span ids, and every span
carries the fid it ran on.

Clock model: span times are each node's CLOCK_MONOTONIC, mutually
meaningless across processes.  Every rpcz dump carries a
{"now_mono_us","now_wall_us"} pair read back-to-back, so each node's
spans first map onto its own wall clock (wall = t + now_wall - now_mono).
Residual inter-node wall skew is then corrected by containment: for each
parent/child pair that crosses nodes, the child's node is shifted so the
child span's midpoint centers inside its parent (the classic rpcz
alignment — a child RPC physically runs within its parent's window),
averaged over all cross-node links and propagated breadth-first from an
anchor node, so chains (client → A → B) come out consistent.

A `torch.profiler` Chrome trace of a node (port only; `--profile`) joins
on the same clock: its events sit at `ts` + `baseTimeNanoseconds` / 1000
µs on the wall clock (the profiler's clock is the wall clock), plus that
node's offset, so the port's host spans (`trpc.*`) and the card's kernels
and copies line up with the node's rpcz spans and timeline.  Each of the
profile's processes (the host, each card) gets a track of its own.

Usage:
    python -m brpc_tpu_torch.tools.trace_stitch --trace-id 1f00d... \\
        --out trace.json host1:port1 host2:port2
    # merge spans of THIS process (e.g. the client side of the trace):
    python -m brpc_tpu_torch.tools.trace_stitch --trace-id 1f00d... \\
        --local client ...
    # one file with spans AND the flight-recorder timeline of every node:
    python -m brpc_tpu_torch.tools.trace_stitch --trace-id 1f00d... \\
        --timeline --local client --out trace.json host1:port1 host2:port2
    # with a profiler trace this process exported (export_chrome_trace):
    python -m brpc_tpu_torch.tools.trace_stitch --local client \\
        --profile profile.json --out trace.json host1:port1

Importable pieces (the port's kv_disagg `--out` uses them): `fetch_rpcz`,
`local_rpcz`, `stitch`, `fetch_timeline`, `local_timeline`.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request
from collections import defaultdict


def fetch_rpcz(endpoint: str, trace_id: str | None = None,
               limit: int = 4096, timeout: float = 5.0) -> dict:
    """One node's structured span dump ({"pid","now_mono_us",
    "now_wall_us","spans":[...]}) via its builtin HTTP service."""
    url = f"http://{endpoint}/rpcz?format=json&limit={limit}"
    if trace_id:
        url += f"&trace_id={trace_id}"
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


def local_rpcz(trace_id: str | None = None, limit: int = 4096) -> dict:
    """THIS process's span dump (no server needed) — the client side of a
    trace usually lives here."""
    from brpc_tpu_torch.rpc import observe

    return observe.rpcz_dump(limit=limit, trace_id=trace_id)


def fetch_timeline(endpoint: str, limit: int = 4096,
                   timeout: float = 5.0) -> dict:
    """One node's flight-recorder dump ({"pid","now_mono_us",
    "now_wall_us","threads":[...]}) via its builtin HTTP service."""
    url = f"http://{endpoint}/timeline?limit={limit}"
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


def local_timeline(limit: int = 4096) -> dict:
    """THIS process's flight-recorder dump (no server needed)."""
    from brpc_tpu_torch.rpc import observe

    return observe.timeline_dump(limit=limit)


def _mid(s: dict) -> float:
    return (float(s["start_us"]) + float(s["end_us"])) / 2.0


def _node_offsets(dumps: dict[str, dict]) -> dict[str, float]:
    """Per-node correction (us) applied ON TOP of the mono→wall mapping,
    aligning nodes via cross-node parent/child containment."""
    # Wall-clock midpoints per span, per node.
    wall_mid: dict[str, dict[str, float]] = {}
    span_node: dict[str, str] = {}
    for node, dump in dumps.items():
        base = float(dump.get("now_wall_us", 0)) - \
            float(dump.get("now_mono_us", 0))
        mids = {}
        for s in dump.get("spans", []):
            mids[s["span_id"]] = _mid(s) + base
            span_node[s["span_id"]] = node
        wall_mid[node] = mids
    # Desired inter-node deltas from cross-node links: moving the child
    # node by (parent_mid - child_mid) centers the child in its parent.
    deltas: dict[tuple[str, str], list[float]] = defaultdict(list)
    for node, dump in dumps.items():
        for s in dump.get("spans", []):
            parent = s.get("parent_span_id", "")
            pnode = span_node.get(parent)
            if pnode is None or pnode == node:
                continue
            want = wall_mid[pnode][parent] - wall_mid[node][s["span_id"]]
            deltas[(pnode, node)].append(want)
    # Propagate from an anchor breadth-first so client → A → B chains
    # shift consistently even though B never links to the client.
    offsets = {}
    nodes = list(dumps)
    if not nodes:
        return offsets
    anchor = nodes[0]
    offsets[anchor] = 0.0
    frontier = [anchor]
    while frontier:
        u = frontier.pop(0)
        for (p, c), ds in deltas.items():
            mean = sum(ds) / len(ds)
            for known, other, sign in ((p, c, 1.0), (c, p, -1.0)):
                if known == u and other not in offsets:
                    offsets[other] = offsets[u] + sign * mean
                    frontier.append(other)
    for n in nodes:  # unlinked nodes ride on their own wall clock
        offsets.setdefault(n, 0.0)
    return offsets


# Synthetic per-node track ids for the flight-recorder's async lanes.
# Real worker tids are kernel tids (well below these); span tracks use
# tid 0/1 — no collisions.
_TL_STRIPE_TID = 900000       # stripe lifecycle (cut / land / done)
_TL_STRIPE_RAIL_TID = 900001  # + rail index: one track per stripe rail
_TL_QOS_TID = 950000          # + lane index: one track per QoS lane
# kStripeSend rail index meaning "the call's primary socket" (head
# frame / dead-rail fallback) — cpp/stat/timeline.h kStripePrimaryRail.
_TL_PRIMARY_RAIL = 0xFFFF
# Rail values with this bit set are one-sided RMA rails (net/rma.h): the
# chunk was written straight into the peer's registered region — no
# ring/socket copy.  Own track family so Perfetto shows the elided
# memcpys next to the copy-path rails.  cpp/stat/timeline.h
# kStripeRmaRailBit.
_TL_RMA_RAIL_BIT = 0x8000
_TL_RMA_RAIL_TID = 900800  # + rma rail index
_TL_PRIMARY_RAIL_TID = 900900  # its own track, distinct from real rails
# kv_block events (net/kvstore.h): block publishes / zero-copy serves /
# evictions / stale-generation rejects on their own per-node track, so a
# disaggregation trace shows block transfers next to the rails that
# carried them.  b = op << 56 | payload len (TIMELINE_KV_OPS mirror).
_TL_KV_TID = 970000
_TL_KV_OPS = {1: "publish", 2: "serve", 3: "evict", 4: "stale",
              5: "promote", 6: "demote"}
# coll_step events (net/collective.h): one instant per completed
# collective schedule step on its own per-node "collective" track —
# a = step index, b = op << 56 | step bytes (TIMELINE_COLL_OPS mirror),
# so a group-transfer trace shows schedule progress next to the rma
# rails that moved the shards.
_TL_COLL_TID = 980000
_TL_COLL_OPS = {1: "all_gather", 2: "reduce_scatter", 3: "all_to_all",
                4: "reshard"}
# coll_ready events (net/collective.h): one instant per transfer fired
# by a producer readiness stamp before the whole-buffer barrier would
# have released it — a = step index, b = chunk << 32 | bytes (chunk =
# dep offset / trpc_coll_ready_granularity_bytes) — its own per-node
# "coll ready" track NEXT to "collective", so compute/comm overlap is
# visible as ready instants interleaving step completions.
_TL_COLL_READY_TID = 981000
# tuner_decision events (stat/tuner.h): one instant per knob actuation
# by the self-tuning controller on its own per-node "tuner" track —
# a = knob hash (tuner::knob_hash of the flag name), b = old << 32 |
# new (32-bit-truncated; the /tuner journal keeps exact values) — so a
# tuning run reads as a Perfetto artifact: decisions next to the rails/
# lanes they retuned.
_TL_TUNER_TID = 990000
# slo_breach events (stat/slo.h): one instant per breach-state EDGE on
# its own per-node "slo" track — a = FNV-1a hash of the tenant name,
# b = op << 56 | fast-window burn rate in milli-units
# (TIMELINE_SLO_OPS mirror: 1 = breach, 2 = clear) — so an incident
# trace shows exactly when a tenant's error budget started and stopped
# burning, next to the fibers and rails that caused it.
_TL_SLO_TID = 991000
_TL_SLO_OPS = {1: "breach", 2: "clear"}
# token_step events (net/infer.h): one instant per continuous-batching
# scheduler transition on its own per-node "inference" track — a =
# request id, b = op << 56 | low bits (TIMELINE_TOKEN_OPS mirror:
# admit carries prefix-cache-matched tokens, token carries the token
# index, eos/cancel carry tokens emitted, shed carries the error
# code) — so a serving trace shows requests joining/leaving the batch
# and every decode step next to the streams that carried the tokens.
_TL_TOKEN_TID = 992000
_TL_TOKEN_OPS = {1: "admit", 2: "prefill_done", 3: "token", 4: "eos",
                 5: "cancel", 6: "shed"}


def _timeline_chrome_events(pid: int, dump: dict, base: float,
                            span_by_id: dict, span_by_fid: dict) -> list:
    """One node's flight-recorder dump → Chrome events: per-worker
    thread tracks with fiber run→park slices (named by the rpcz span
    they execute when the join resolves) and messenger sweep /
    inline-response slices nested under them, scheduler/write-path
    instants, plus synthetic stripe-rail and QoS-lane tracks."""
    events = []
    named_tids = set()

    def track(tid: int, name: str) -> int:
        if tid not in named_tids:
            named_tids.add(tid)
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": name}})
        return tid

    for thr in dump.get("threads", []):
        tid = int(thr["tid"])
        track(tid, f"{thr.get('name', 'thread')} (tid {tid})")
        open_fiber: dict = {}  # fid(hex of event `a`... keyed by a) -> (ts, ev)
        open_span: dict = {}   # (event name, a) -> (ts, ev)
        for e in thr.get("events", []):
            name = e.get("name", "?")
            ts = float(e["ts_us"]) + base
            if name == "fiber_run":
                open_fiber[e["a"]] = (ts, e)
                continue
            if name in ("fiber_park", "fiber_done") and e["a"] in open_fiber:
                t0, run = open_fiber.pop(e["a"])
                # Exact span join: the run/park events carry the fiber's
                # own id in `fid` and its ambient span in `span_id`;
                # spans carry the fid they started on.
                method = (span_by_id.get(run["span_id"])
                          or span_by_fid.get(run["fid"]))
                label = (f"fiber:{method}" if method
                         else f"fiber {run['fid'][-8:]}")
                events.append({
                    "ph": "X", "name": label, "cat": "fiber",
                    "pid": pid, "tid": tid, "ts": t0,
                    "dur": max(ts - t0, 1.0),
                    "args": {"fid": run["fid"],
                             "trace_id": run["trace_id"],
                             "span_id": run["span_id"],
                             "worker": int(run["b"], 16),
                             "end": name},
                })
                continue
            if name in ("sweep_start", "inline_begin"):
                open_span[(name, e["a"])] = (ts, e)
                continue
            if name == "sweep_end" and ("sweep_start", e["a"]) in open_span:
                t0, _ = open_span.pop(("sweep_start", e["a"]))
                events.append({
                    "ph": "X", "name": "sweep", "cat": "messenger",
                    "pid": pid, "tid": tid, "ts": t0,
                    "dur": max(ts - t0, 1.0),
                    "args": {"socket": e["a"], "cuts": int(e["b"], 16),
                             "trace_id": e["trace_id"]},
                })
                continue
            if name == "inline_end" and \
                    ("inline_begin", e["a"]) in open_span:
                t0, _ = open_span.pop(("inline_begin", e["a"]))
                events.append({
                    "ph": "X", "name": "inline-response",
                    "cat": "messenger", "pid": pid, "tid": tid, "ts": t0,
                    "dur": max(ts - t0, 1.0),
                    "args": {"socket": e["a"], "trace_id": e["trace_id"]},
                })
                continue
            # Everything else renders as an instant; stripe/QoS/kv events
            # additionally land on their synthetic async tracks.
            out_tid = tid
            if name == "kv_block":
                b = int(e["b"], 16)
                op = b >> 56
                out_tid = track(_TL_KV_TID, "kv blocks")
                events.append({
                    "ph": "i", "s": "t", "cat": "timeline",
                    "name": f"kv_{_TL_KV_OPS.get(op, op)}",
                    "pid": pid, "tid": out_tid, "ts": ts,
                    "args": {"block_id": e["a"],
                             "len": b & ((1 << 56) - 1),
                             "trace_id": e["trace_id"],
                             "span_id": e["span_id"], "fid": e["fid"]},
                })
                continue
            if name == "coll_step":
                b = int(e["b"], 16)
                op = b >> 56
                out_tid = track(_TL_COLL_TID, "collective")
                events.append({
                    "ph": "i", "s": "t", "cat": "timeline",
                    "name": f"coll_{_TL_COLL_OPS.get(op, op)}",
                    "pid": pid, "tid": out_tid, "ts": ts,
                    "args": {"step": int(e["a"], 16),
                             "bytes": b & ((1 << 56) - 1),
                             "trace_id": e["trace_id"],
                             "span_id": e["span_id"], "fid": e["fid"]},
                })
                continue
            if name == "coll_ready":
                b = int(e["b"], 16)
                out_tid = track(_TL_COLL_READY_TID, "coll ready")
                events.append({
                    "ph": "i", "s": "t", "cat": "timeline",
                    "name": "coll_ready",
                    "pid": pid, "tid": out_tid, "ts": ts,
                    "args": {"step": int(e["a"], 16),
                             "chunk": b >> 32,
                             "bytes": b & 0xFFFFFFFF,
                             "trace_id": e["trace_id"],
                             "span_id": e["span_id"], "fid": e["fid"]},
                })
                continue
            if name == "slo_breach":
                b = int(e["b"], 16)
                op = b >> 56
                out_tid = track(_TL_SLO_TID, "slo")
                events.append({
                    "ph": "i", "s": "t", "cat": "timeline",
                    "name": f"slo_{_TL_SLO_OPS.get(op, op)}",
                    "pid": pid, "tid": out_tid, "ts": ts,
                    "args": {"tenant_hash": e["a"],
                             "burn_fast_milli": b & ((1 << 56) - 1),
                             "trace_id": e["trace_id"],
                             "span_id": e["span_id"], "fid": e["fid"]},
                })
                continue
            if name == "token_step":
                b = int(e["b"], 16)
                op = b >> 56
                out_tid = track(_TL_TOKEN_TID, "inference")
                events.append({
                    "ph": "i", "s": "t", "cat": "timeline",
                    "name": f"infer_{_TL_TOKEN_OPS.get(op, op)}",
                    "pid": pid, "tid": out_tid, "ts": ts,
                    "args": {"request_id": e["a"],
                             "value": b & ((1 << 56) - 1),
                             "trace_id": e["trace_id"],
                             "span_id": e["span_id"], "fid": e["fid"]},
                })
                continue
            if name == "tuner_decision":
                b = int(e["b"], 16)
                out_tid = track(_TL_TUNER_TID, "tuner")
                events.append({
                    "ph": "i", "s": "t", "cat": "timeline",
                    "name": "tuner_decision",
                    "pid": pid, "tid": out_tid, "ts": ts,
                    "args": {"knob_hash": e["a"],
                             "old": b >> 32,
                             "new": b & 0xFFFFFFFF,
                             "trace_id": e["trace_id"],
                             "span_id": e["span_id"], "fid": e["fid"]},
                })
                continue
            if name == "stripe_send":
                rail = int(e["b"], 16) >> 48
                if rail == _TL_PRIMARY_RAIL:
                    out_tid = track(_TL_PRIMARY_RAIL_TID,
                                    "stripe primary (head/fallback)")
                elif rail & _TL_RMA_RAIL_BIT:
                    rma_rail = rail & 0x7FFF
                    out_tid = track(_TL_RMA_RAIL_TID + rma_rail,
                                    f"rma rail {rma_rail}")
                else:
                    out_tid = track(_TL_STRIPE_RAIL_TID + rail,
                                    f"stripe rail {rail}")
            elif name in ("stripe_cut", "stripe_land", "stripe_done"):
                out_tid = track(_TL_STRIPE_TID, "stripe lifecycle")
            elif name == "qos_drain":
                lane = int(e["a"], 16) & 0xff
                out_tid = track(_TL_QOS_TID + lane, f"qos lane {lane}")
            events.append({
                "ph": "i", "name": name, "s": "t", "cat": "timeline",
                "pid": pid, "tid": out_tid, "ts": ts,
                "args": {"a": e["a"], "b": e["b"],
                         "trace_id": e["trace_id"],
                         "span_id": e["span_id"], "fid": e["fid"]},
            })
    return events


def _profile_chrome_events(node: str, profile: dict, base_us: float,
                           first_pid: int) -> list:
    """One node's torch.profiler Chrome trace → its events on the stitched
    wall clock (`ts` + `base_us`), each of its processes on a new pid
    from `first_pid` up, named after the node."""
    pids: dict = {}
    events = []
    for e in profile.get("traceEvents", []):
        if "pid" not in e:
            continue
        e = dict(e)
        if e["pid"] not in pids:
            pids[e["pid"]] = first_pid + len(pids)
            events.append({"ph": "M", "name": "process_name",
                           "pid": pids[e["pid"]],
                           "args": {"name": f"{node} (profiler "
                                            f"{e['pid']})"}})
        e["pid"] = pids[e["pid"]]
        if e.get("ph") == "M" and e.get("name") == "process_name":
            continue  # named above
        if "ts" in e:
            e["ts"] = float(e["ts"]) + base_us
        events.append(e)
    return events


def stitch(dumps: dict[str, dict], trace_id: str | None = None,
           timeline_dumps: dict[str, dict] | None = None,
           profiles: dict[str, dict] | None = None) -> dict:
    """Joins {node_name: rpcz_dump} into one Chrome trace-event object.

    Returns {"traceEvents": [...], "displayTimeUnit": "ms", "stitch":
    {summary}} — JSON-dumpable straight into Perfetto.  When `trace_id`
    is given, spans from other traces are dropped (belt + braces for
    dumps fetched without the server-side filter).  `timeline_dumps`
    ({node_name: /timeline dump}) merges each node's flight-recorder
    events into the same file on the same corrected clocks — timeline
    events are NOT trace-filtered (the scheduling/transport context
    AROUND a span is exactly what the timeline tier exists to show).
    `profiles` ({node_name: torch.profiler Chrome trace}) merges each
    node's profiler events the same way (the summary then counts them as
    "profile_events")."""
    offsets = _node_offsets(dumps)
    # Global index for parent-link accounting (across ALL nodes).
    all_ids = set()
    for dump in dumps.values():
        for s in dump.get("spans", []):
            if trace_id and s["trace_id"] != trace_id:
                continue
            all_ids.add(s["span_id"])
    events = []
    parent_linked = 0
    spans_total = 0
    for pid, (node, dump) in enumerate(sorted(dumps.items())):
        base = float(dump.get("now_wall_us", 0)) - \
            float(dump.get("now_mono_us", 0)) + offsets[node]
        events.append({
            "ph": "M", "name": "process_name", "pid": pid,
            "args": {"name": f"{node} (pid {dump.get('pid', '?')})"},
        })
        for tid, tname in ((0, "server spans"), (1, "client spans")):
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": tname},
            })
        for s in dump.get("spans", []):
            if trace_id and s["trace_id"] != trace_id:
                continue
            spans_total += 1
            start = float(s["start_us"]) + base
            dur = max(float(s["end_us"]) - float(s["start_us"]), 1.0)
            linked = s.get("parent_span_id", "0" * 16) in all_ids
            parent_linked += 1 if linked else 0
            tid = 0 if s["side"] == "server" else 1
            events.append({
                "ph": "X", "name": s["method"], "cat": s["side"],
                "pid": pid, "tid": tid, "ts": start, "dur": dur,
                "args": {
                    "trace_id": s["trace_id"], "span_id": s["span_id"],
                    "parent_span_id": s["parent_span_id"],
                    "parent_linked": linked,
                    "fid": s.get("fid", "0" * 16),
                    "error_code": s["error_code"],
                    "request_bytes": s["request_bytes"],
                    "response_bytes": s["response_bytes"],
                },
            })
            for a in s.get("annotations", []):
                events.append({
                    "ph": "i", "name": a["text"], "s": "t",
                    "pid": pid, "tid": tid,
                    "ts": float(a["ts_us"]) + base,
                })
    timeline_events = 0
    if timeline_dumps:
        pid_of = {node: p for p, node in enumerate(sorted(dumps))}
        next_pid = len(pid_of)
        for node in sorted(timeline_dumps):
            tl = timeline_dumps[node]
            if node not in pid_of:  # timeline-only node: its own track
                pid_of[node] = next_pid
                events.append({
                    "ph": "M", "name": "process_name",
                    "pid": next_pid,
                    "args": {"name": f"{node} (pid {tl.get('pid', '?')})"},
                })
                next_pid += 1
            base = float(tl.get("now_wall_us", 0)) - \
                float(tl.get("now_mono_us", 0)) + offsets.get(node, 0.0)
            # Span join tables for fiber-slice naming, restricted to
            # this node's spans (fibers never execute a remote span).
            span_by_id: dict = {}
            span_by_fid: dict = {}
            for s in dumps.get(node, {}).get("spans", []):
                if trace_id and s["trace_id"] != trace_id:
                    continue
                span_by_id[s["span_id"]] = s["method"]
                fid = s.get("fid", "0" * 16)
                if fid != "0" * 16:
                    span_by_fid.setdefault(fid, s["method"])
            evs = _timeline_chrome_events(pid_of[node], tl, base,
                                          span_by_id, span_by_fid)
            timeline_events += sum(1 for e in evs if e["ph"] != "M")
            events.extend(evs)
    profile_events = 0
    next_pid = 1 + max((e["pid"] for e in events if "pid" in e), default=-1)
    for node in sorted(profiles or {}):
        prof = profiles[node]
        base = (float(prof.get("baseTimeNanoseconds", 0)) / 1000.0
                + offsets.get(node, 0.0))
        evs = _profile_chrome_events(node, prof, base, next_pid)
        next_pid = 1 + max((e["pid"] for e in evs), default=next_pid - 1)
        profile_events += sum(1 for e in evs if e.get("ph") != "M")
        events.extend(evs)
    # Rebase so the trace starts near 0 (Perfetto-friendly); timeline
    # events can precede the first span, so take the global minimum.
    t0 = min((e["ts"] for e in events if "ts" in e), default=None)
    if t0 is not None:
        for e in events:
            if "ts" in e:
                e["ts"] -= t0
    summary = {
        "trace_id": trace_id,
        "nodes": sorted(dumps),
        "spans": spans_total,
        "parent_linked": parent_linked,
        "timeline_events": timeline_events,
        "timeline_nodes": sorted(timeline_dumps or {}),
        "node_offsets_us": {n: round(v, 1) for n, v in offsets.items()},
    }
    if profiles:
        summary["profile_events"] = profile_events
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "stitch": summary}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="stitch rpcz spans from N nodes into Chrome trace "
                    "JSON (Perfetto)")
    ap.add_argument("endpoints", nargs="*",
                    help="host:port of each node's builtin service")
    ap.add_argument("--trace-id", default=None,
                    help="hex trace id to stitch (default: everything)")
    ap.add_argument("--limit", type=int, default=4096,
                    help="max spans pulled per node")
    ap.add_argument("--local", metavar="NAME", default=None,
                    help="also merge THIS process's spans as node NAME")
    ap.add_argument("--timeline", action="store_true",
                    help="also pull each node's /timeline flight-recorder "
                         "dump and merge fiber/messenger/stripe/QoS "
                         "events into the same Perfetto file")
    ap.add_argument("--timeline-limit", type=int, default=4096,
                    help="max timeline events pulled per node thread")
    ap.add_argument("--profile", metavar="PATH", default=None,
                    help="a torch.profiler Chrome trace of THIS process "
                         "(export_chrome_trace), merged on the wall clock "
                         "as the --local node (default name: local)")
    ap.add_argument("--out", default="-",
                    help="output path (default: stdout)")
    args = ap.parse_args(argv)
    dumps: dict[str, dict] = {}
    for ep in args.endpoints:
        dumps[ep] = fetch_rpcz(ep, args.trace_id, args.limit)
    if args.local:
        dumps[args.local] = local_rpcz(args.trace_id, args.limit)
    profiles: dict[str, dict] = {}
    if args.profile:
        with open(args.profile) as f:
            profiles[args.local or "local"] = json.load(f)
    if not dumps and not profiles:
        ap.error("no endpoints given (and neither --local nor --profile)")
    timeline_dumps: dict[str, dict] | None = None
    if args.timeline:
        timeline_dumps = {}
        for ep in args.endpoints:
            timeline_dumps[ep] = fetch_timeline(ep, args.timeline_limit)
        if args.local:
            timeline_dumps[args.local] = local_timeline(
                args.timeline_limit)
    trace = stitch(dumps, args.trace_id, timeline_dumps, profiles or None)
    text = json.dumps(trace)
    if args.out == "-":
        print(text)
    else:
        with open(args.out, "w") as f:
            f.write(text)
        s = trace["stitch"]
        print(f"wrote {args.out}: {s['spans']} spans "
              f"({s['parent_linked']} parent-linked) + "
              f"{s['timeline_events']} timeline events + "
              f"{s.get('profile_events', 0)} profiler events from "
              f"{len(s['nodes'])} nodes", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
