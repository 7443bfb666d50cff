"""Replay a production traffic capture against a live server — port of
tools/traffic_replay.py, over the port's `rpc/capture.py`.  Host-only.

Consumes the capture files written by `capture.dump()` / the
`/capture?dump=` builtin (recordio envelope, "TRPCCAP1" header + packed
per-request metadata records — see brpc_tpu_torch/rpc/capture.py; the
same files whichever package wrote them) and re-offers the recorded
traffic shape to a target server:

exact mode (default)
    Open-loop replay: every recorded request is re-sent at its recorded
    inter-arrival offset (scaled by --time-scale), with the recorded
    tenant/priority re-stamped as wire tail-group 5 and the recorded
    deadline budget re-stamped as tail-group 7 (Batch.submit timeout).
    Open-loop means the sender never waits for responses to pace itself,
    so server-side queueing and shedding behave as they did in
    production — a closed loop would self-throttle and hide overload.

statistical mode (--mode stat)
    Fits the capture instead of replaying it verbatim: per-tenant
    arrival processes from the header summary (Poisson gaps; a bursty
    two-state modulated process when the recorded burstiness CV says
    the traffic wasn't Poisson), with sizes/methods/priorities/budgets
    resampled from the recorded per-tenant empirical distribution.
    --rate-scale 2.0 offers twice the recorded rate — the
    shed-don't-degrade regression shape (excess must shed as typed
    kEOverloaded/kEDeadlineExpired, never as untyped failures).

The orchestrator splits records[i::N] across N worker processes, so the
combined arrival process is exactly the recorded one; each worker keeps
one Batch per (tenant, priority) lane and polls completions without
blocking the send schedule.  The final JSON compares replayed per-tenant
rate and client p99 against the recorded baseline embedded in the
capture header, and classifies every error as typed (deadline/overload
shed) or untyped.

Usage:
  python -m brpc_tpu_torch.tools.traffic_replay --addr 127.0.0.1:8000 \
      --capture cap.bin
  python -m brpc_tpu_torch.tools.traffic_replay --addr ... \
      --capture cap.bin --mode stat --rate-scale 2.0 --duration 5

The workers are this module again (`--role worker`).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time

from brpc_tpu_torch.rpc import Batch, Channel
from brpc_tpu_torch.rpc.capture import CaptureRecord, load_capture

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODULE = "brpc_tpu_torch.tools.traffic_replay"

# Status codes that count as *typed* sheds under overload: the server
# refusing work it cannot finish (qos admission, deadline propagation,
# drain) rather than failing it.  Anything else during replay is a
# regression.  Mirrors ERROR_CODES in brpc_tpu_torch/rpc/_lib.py.
TYPED_SHED_CODES = {2004, 2005, 2006, 2007}  # kELimit, kEOverloaded,
#                                              kEDraining, kEDeadlineExpired
K_DEADLINE_EXPIRED = 2007
ETIMEDOUT = 110  # client-side timer fired before any response

# Latency samples each worker ships back per tenant (uniform reservoir;
# the orchestrator merges workers' reservoirs before computing
# percentiles, so no single worker's tail dominates by accident).
LAT_SAMPLES_PER_TENANT = 5000


def percentile(sorted_vals: list[float], p: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(len(sorted_vals) * p))
    return sorted_vals[idx]


class TenantStats:
    __slots__ = ("sent", "ok", "errors", "lats", "_seen", "_rng")

    def __init__(self, seed: int):
        self.sent = 0
        self.ok = 0
        self.errors: dict[int, int] = {}
        self.lats: list[float] = []
        self._seen = 0
        self._rng = random.Random(seed)

    def record(self, status: int, lat_us: float) -> None:
        if status == 0:
            self.ok += 1
            # Algorithm R over ok-latencies: bounded memory however long
            # the replay runs.
            self._seen += 1
            if len(self.lats) < LAT_SAMPLES_PER_TENANT:
                self.lats.append(lat_us)
            else:
                j = self._rng.randrange(self._seen)
                if j < LAT_SAMPLES_PER_TENANT:
                    self.lats[j] = lat_us
        else:
            self.errors[status] = self.errors.get(status, 0) + 1


# ---------------------------------------------------------------------------
# schedule construction
# ---------------------------------------------------------------------------

def exact_schedule(records: list[CaptureRecord], index: int, workers: int,
                   time_scale: float) -> list[tuple[float, CaptureRecord]]:
    """This worker's slice of the recorded arrival process: (offset
    seconds from replay start, record).  Slicing records[index::workers]
    keeps every record's ABSOLUTE recorded offset, so the union across
    workers reproduces the recorded inter-arrival sequence exactly."""
    if not records:
        return []
    t0 = records[0].arrival_mono_us
    return [((r.arrival_mono_us - t0) / 1e6 / time_scale, r)
            for r in records[index::workers]]


def _arrival_times(rng: random.Random, rate: float, duration: float,
                   cv: float) -> list[float]:
    """Synthetic arrival offsets for one tenant.  Poisson (exponential
    gaps) when the recorded per-second rate series looked Poisson-ish;
    a two-state modulated process (alternating hi/lo rate phases with
    exponential dwell times — MMPP-2) when the recorded burstiness CV
    says otherwise.  Both have mean rate `rate`."""
    out: list[float] = []
    t = 0.0
    if cv <= 1.5:
        while t < duration:
            t += rng.expovariate(rate)
            if t < duration:
                out.append(t)
        return out
    # Bursty: half the time at 1.6x rate, half at 0.4x (mean = rate),
    # phase dwell ~ exp(0.4s).
    hi, lo = rate * 1.6, max(rate * 0.4, 1e-6)
    in_hi = True
    phase_end = rng.expovariate(1.0 / 0.4)
    while t < duration:
        r = hi if in_hi else lo
        t += rng.expovariate(r)
        if t >= phase_end:
            in_hi = not in_hi
            phase_end = t + rng.expovariate(1.0 / 0.4)
        if t < duration:
            out.append(t)
    return out


def stat_schedule(header: dict, records: list[CaptureRecord], index: int,
                  workers: int, rate_scale: float, duration: float,
                  seed: int) -> list[tuple[float, CaptureRecord]]:
    """Fitted schedule: per-tenant Poisson/bursty arrivals at
    recorded-rate * rate_scale / workers, each event resampling
    (size, method, priority, budget) from that tenant's recorded
    empirical pool."""
    summary = header.get("summary", {})
    tenants = summary.get("tenants", {})
    cv = float(summary.get("burstiness_cv", 0.0))
    pools: dict[str, list[CaptureRecord]] = {}
    for r in records:
        pools.setdefault(r.tenant, []).append(r)
    events: list[tuple[float, CaptureRecord]] = []
    for tname, tinfo in sorted(tenants.items()):
        pool = pools.get(tname)
        if not pool:
            continue
        rate = float(tinfo.get("est_rate_rps", 0.0)) * rate_scale / workers
        if rate <= 0:
            continue
        # Distinct stream per (seed, worker, tenant): workers and
        # tenants must not replay correlated noise.
        rng = random.Random((seed * 1000003 + index) ^ hash(tname) & 0xFFFF)
        for t in _arrival_times(rng, rate, duration, cv):
            events.append((t, rng.choice(pool)))
    events.sort(key=lambda e: e[0])
    return events


# ---------------------------------------------------------------------------
# worker: open-loop send/poll
# ---------------------------------------------------------------------------

def run_worker(args: argparse.Namespace) -> int:
    header, records = load_capture(args.capture)
    if args.mode == "exact":
        schedule = exact_schedule(records, args.index, args.workers,
                                  args.time_scale)
    else:
        schedule = stat_schedule(header, records, args.index, args.workers,
                                 args.rate_scale, args.duration, args.seed)

    # One Batch per (tenant, priority): the channel's QoS tag stamps
    # wire tail-group 5 on every call it carries.
    lanes: dict[tuple[str, int], tuple[Channel, Batch]] = {}
    # pending[(lane, token)] = (tenant, send-time, had-deadline-budget)
    pending: dict[tuple[tuple[str, int], int], tuple[str, float, bool]] = {}
    stats: dict[str, TenantStats] = {}
    payload_cache: dict[int, bytes] = {}

    def lane_for(rec: CaptureRecord) -> tuple[tuple[str, int], Batch]:
        key = (rec.tenant, rec.priority)
        ent = lanes.get(key)
        if ent is None:
            ch = Channel(args.addr, timeout_ms=args.default_timeout_ms,
                         connection_type=args.conn_type,
                         qos_tenant=rec.tenant, qos_priority=rec.priority)
            ent = (ch, Batch(ch))
            lanes[key] = ent
        return key, ent[1]

    def drain(blocking_ms: int) -> None:
        for key, (_, batch) in lanes.items():
            while True:
                comps = batch.poll(max_n=64, timeout_ms=blocking_ms)
                if not comps:
                    break
                now = time.monotonic()
                for c in comps:
                    tenant, sent_at, had_budget = pending.pop(
                        (key, c.token), ("", now, False))
                    st = stats.get(tenant)
                    if st is not None:
                        status = c.status
                        # A client-side timer firing on a call that
                        # carried a RECORDED deadline budget is the
                        # deadline expiring as observed from the client
                        # (the server-side 2007 response lost the race
                        # with the local timer) — a typed shed, not an
                        # untyped failure.  Timeouts on budget-less
                        # calls stay untyped: those can hide hangs.
                        if status == ETIMEDOUT and had_budget:
                            status = K_DEADLINE_EXPIRED
                        st.record(status, (now - sent_at) * 1e6)
                blocking_ms = 0  # only the first poll per lane may block

    start = time.monotonic() + 0.15  # common epoch after setup
    for offset, rec in schedule:
        target = start + offset
        # Service completions while waiting for the next send slot —
        # never the other way round (open loop).
        while True:
            now = time.monotonic()
            if now >= target:
                break
            drain(0)
            slack = target - time.monotonic()
            if slack > 0.0005:
                time.sleep(min(slack, 0.002))
        if len(pending) >= args.max_inflight:
            # Memory backstop, not pacing: poll blocking until below.
            while len(pending) >= args.max_inflight:
                drain(5)
        key, batch = lane_for(rec)
        size = min(rec.request_bytes, args.max_payload)
        payload = payload_cache.get(size)
        if payload is None:
            payload = b"x" * size
            payload_cache[size] = payload
        # Recorded deadline budget re-stamped as tail-group 7 (submit's
        # timeout_ms drives the wire deadline when trpc_deadline_wire).
        timeout_ms = (max(1, rec.deadline_budget_us // 1000)
                      if rec.deadline_budget_us else args.default_timeout_ms)
        st = stats.get(rec.tenant)
        if st is None:
            st = stats[rec.tenant] = TenantStats(args.seed + args.index)
        tokens = batch.submit(rec.method or "Echo.Echo", [payload],
                              timeout_ms=timeout_ms)
        st.sent += 1
        pending[(key, tokens[0])] = (rec.tenant, time.monotonic(),
                                     rec.deadline_budget_us != 0)

    # Final drain: everything in flight either completes or times out
    # server/client side within the drain budget.
    deadline = time.monotonic() + args.drain_s
    while pending and time.monotonic() < deadline:
        drain(20)
    for _, (ch, batch) in lanes.items():
        batch.close()
        ch.close()

    wall = max(time.monotonic() - start, 1e-6)
    report = {"worker": args.index, "duration_s": wall, "tenants": {}}
    for tenant, st in stats.items():
        lat = sorted(st.lats)
        report["tenants"][tenant] = {
            "sent": st.sent,
            "ok": st.ok,
            "errors": {str(k): v for k, v in sorted(st.errors.items())},
            "unpolled": sum(1 for (t, _, _) in pending.values()
                            if t == tenant),
            "lat_samples": lat,
        }
    print(json.dumps(report), flush=True)
    return 0


# ---------------------------------------------------------------------------
# orchestrator: fan out, merge, compare against the recorded baseline
# ---------------------------------------------------------------------------

def run_orchestrator(args: argparse.Namespace) -> int:
    header, records = load_capture(args.capture)
    if not records:
        print(json.dumps({"error": "empty capture"}))
        return 1
    procs = []
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for i in range(args.workers):
        cmd = [sys.executable, "-m", MODULE,
               "--role", "worker", "--addr", args.addr,
               "--capture", args.capture, "--mode", args.mode,
               "--index", str(i), "--workers", str(args.workers),
               "--time-scale", str(args.time_scale),
               "--rate-scale", str(args.rate_scale),
               "--duration", str(args.duration),
               "--seed", str(args.seed),
               "--max-inflight", str(args.max_inflight),
               "--max-payload", str(args.max_payload),
               "--default-timeout-ms", str(args.default_timeout_ms),
               "--conn-type", args.conn_type,
               "--drain-s", str(args.drain_s)]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, env=env))

    merged: dict[str, dict] = {}
    wall = 0.0
    failed = 0
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10)
            failed += 1
            continue
        if p.returncode != 0:
            failed += 1
            continue
        rep = json.loads(out.decode().strip().splitlines()[-1])
        wall = max(wall, rep["duration_s"])
        for tenant, t in rep["tenants"].items():
            m = merged.setdefault(tenant, {
                "sent": 0, "ok": 0, "errors": {}, "unpolled": 0,
                "lat_samples": []})
            m["sent"] += t["sent"]
            m["ok"] += t["ok"]
            m["unpolled"] += t["unpolled"]
            for code, n in t["errors"].items():
                m["errors"][code] = m["errors"].get(code, 0) + n
            m["lat_samples"].extend(t["lat_samples"])

    # Recorded per-tenant baseline from the capture header (server-side
    # queue+handler p99 and permille-corrected rate estimate).
    recorded = header.get("summary", {}).get("tenants", {})
    result = {
        "mode": args.mode,
        "workers": args.workers,
        "worker_failures": failed,
        "capture": {
            "records": len(records),
            "window_us": header.get("summary", {}).get("window_us", 0),
            "burstiness_cv": header.get("summary", {}).get(
                "burstiness_cv", 0.0),
        },
        "duration_s": wall,
        "tenants": {},
    }
    untyped = 0
    for tenant, m in sorted(merged.items()):
        lat = sorted(m.pop("lat_samples"))
        base = recorded.get(tenant, {})
        rec_rate = float(base.get("est_rate_rps", 0.0))
        want_rate = rec_rate * (args.rate_scale if args.mode == "stat"
                                else 1.0 / args.time_scale)
        got_rate = m["sent"] / wall if wall > 0 else 0.0
        untyped += sum(n for code, n in m["errors"].items()
                       if int(code) not in TYPED_SHED_CODES)
        result["tenants"][tenant] = {
            **m,
            "client_p50_us": percentile(lat, 0.50),
            "client_p99_us": percentile(lat, 0.99),
            "replayed_rate_rps": got_rate,
            "recorded_rate_rps": rec_rate,
            "target_rate_rps": want_rate,
            "rate_ratio": (got_rate / want_rate) if want_rate > 0 else 0.0,
            "recorded_p99_us": float(base.get("p99_us", 0.0)),
            "recorded_handler_p99_us": float(base.get(
                "handler_p99_us", 0.0)),
        }
    result["typed_errors_only"] = untyped == 0
    result["untyped_errors"] = untyped
    print(json.dumps(result, indent=2 if sys.stdout.isatty() else None))
    return 0 if failed == 0 else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--role", choices=["orchestrator", "worker"],
                    default="orchestrator")
    ap.add_argument("--addr", required=True,
                    help="target server host:port")
    ap.add_argument("--capture", required=True,
                    help="capture file (from /capture?dump= or "
                         "capture.dump)")
    ap.add_argument("--mode", choices=["exact", "stat"], default="exact")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--index", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--time-scale", type=float, default=1.0,
                    help="exact mode: divide inter-arrival gaps "
                         "(2.0 replays twice as fast)")
    ap.add_argument("--rate-scale", type=float, default=1.0,
                    help="stat mode: multiply fitted per-tenant rates")
    ap.add_argument("--duration", type=float, default=5.0,
                    help="stat mode: synthetic window length (s)")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--max-inflight", type=int, default=4096,
                    help="per-worker in-flight cap (memory backstop; "
                         "open-loop pacing is unaffected below it)")
    ap.add_argument("--max-payload", type=int, default=1 << 24,
                    help="clamp replayed request bodies (bytes)")
    ap.add_argument("--default-timeout-ms", type=int, default=10000,
                    help="timeout for records with no recorded budget")
    ap.add_argument("--conn-type", default="pooled",
                    choices=["single", "pooled", "short"],
                    help="replay channel connection type (pooled default: "
                         "big striped bodies overlap across sockets "
                         "instead of serializing on one — open-loop "
                         "replay of concurrent traffic needs this)")
    ap.add_argument("--drain-s", type=float, default=5.0,
                    help="final completion-drain budget (s)")
    args = ap.parse_args(argv)
    if args.role == "worker":
        return run_worker(args)
    return run_orchestrator(args)


if __name__ == "__main__":
    sys.exit(main())
