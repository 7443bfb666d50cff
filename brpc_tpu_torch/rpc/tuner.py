"""Self-tuning runtime controller (the /tuner page, in-process) — port of
brpc_tpu/rpc/tuner.py.

The native runtime carries ~30 validated reloadable flags and the var
surfaces to see exactly where time goes; `cpp/stat/tuner.cc` closes the
loop — a control loop samples the vars on a `trpc_tuner_interval_ms`
tick and drives per-knob feedback rules (hill-climb / AIMD with
hysteresis, cooldown and a revert-on-regression guard) through the
validated flag-reload path only.  This module is the ctypes surface:

- `enable_tuner()` / `tuner_enabled()` flip and read the reloadable
  `trpc_tuner` flag (default off; while off no thread runs, nothing is
  sampled, and the tuner vars stay frozen at 0);
- `status()` returns the full /tuner body: counters, the live rule
  table (knob, mode, effective bounds, freeze/cooldown state), the
  sampled input vars, and the structured decision journal;
- `decisions()` returns the journal as typed records — every knob
  change, revert and freeze, with the metric readings that drove it.

Every decision is also a `tuner_decision` timeline event (a = knob
hash, b = old<<32|new), so a tuning run shows up as its own track in
`tools/trace_stitch.py --timeline` Perfetto artifacts.
"""

from __future__ import annotations

import ctypes
import json
from dataclasses import dataclass

from brpc_tpu_torch.rpc._lib import load_library
from brpc_tpu_torch.rpc.flags import set_flag
from brpc_tpu_torch.rpc.observe import _dump_with_retry


def enable_tuner(on: bool = True) -> None:
    """Flips the self-tuning controller (the reloadable `trpc_tuner`
    flag; off by default — flag-off cost is nothing: no thread, no
    sampling, no knob ever touched)."""
    set_flag("trpc_tuner", "true" if on else "false")


def tuner_enabled() -> bool:
    return load_library().trpc_tuner_enabled() == 1


def reset_tuner() -> None:
    """Test support: clears rules/state/journal/counters.  Call with the
    tuner OFF."""
    load_library().trpc_tuner_reset()


def status(limit: int = 128) -> dict:
    """The raw /tuner body for THIS process: {"enabled", "interval_ms",
    "ticks_total", "decisions_total", "reverts_total", "freezes_total",
    "rules": [...], "inputs": {...}, "decisions": [...]}."""
    lib = load_library()
    raw = _dump_with_retry(
        lambda buf, n: lib.trpc_tuner_dump(limit, buf, n))
    return json.loads(raw.decode())


@dataclass(frozen=True)
class TunerDecision:
    """One journal entry: a knob change the controller applied (or
    rolled back / froze), with the metric readings that drove it."""

    seq: int
    ts_mono_us: int
    ts_wall_us: int
    knob: str
    old: int
    new: int
    action: str  # "apply" | "revert" | "freeze"
    reason: str
    metric_before: float
    metric_after: float
    old_str: str = ""  # string knobs (qos lane weights)
    new_str: str = ""


def decisions(limit: int = 128) -> list[TunerDecision]:
    """The decision journal, oldest first (newest `limit` entries)."""
    out = []
    for d in status(limit)["decisions"]:
        out.append(TunerDecision(
            seq=int(d["seq"]), ts_mono_us=int(d["ts_mono_us"]),
            ts_wall_us=int(d["ts_wall_us"]), knob=d["knob"],
            old=int(d["old"]), new=int(d["new"]), action=d["action"],
            reason=d["reason"],
            metric_before=float(d["metric_before"]),
            metric_after=float(d["metric_after"]),
            old_str=d.get("old_str", ""), new_str=d.get("new_str", "")))
    return out


def counters() -> dict:
    """Lifetime counters in one crossing: {"ticks", "decisions",
    "reverts", "freezes"} — provably frozen at 0 while `trpc_tuner` has
    never been on."""
    lib = load_library()
    t = ctypes.c_uint64()
    d = ctypes.c_uint64()
    r = ctypes.c_uint64()
    f = ctypes.c_uint64()
    lib.trpc_tuner_counters(ctypes.byref(t), ctypes.byref(d),
                            ctypes.byref(r), ctypes.byref(f))
    return {"ticks": t.value, "decisions": d.value, "reverts": r.value,
            "freezes": f.value}
