"""Record a golden traffic capture — port of tools/make_golden_capture.py.

The reference regenerates tests/data/golden_mixed.cap, the checked-in
capture that gates its replay regression.  This port records the same
window through the port's `rpc/capture.py`, with senders that import the
port, to `--out` (by default build/golden_mixed.cap); it never writes the
reference's tests/data/golden_mixed.cap.  Host-only: no device work.

The canonical window (~4s, QoS-laned server):
  - tenant "fg": two sender processes, 1KB echo at ~500/s combined,
    every 5th call under a 500ms deadline scope (tail-group 7 on wire);
  - tenant "bulk": one OPEN-LOOP sender (Batch, 100ms cadence, bounded
    in-flight), 4MB bodies — above trpc_stripe_threshold, so they ride
    the striped path.  Open-loop on purpose: the replayer is open-loop,
    and a closed-loop recording would hand it a baseline that never
    self-overlaps.

The capture header embeds the recorded per-tenant baseline (p99, rate)
a replay compares against, so record on the class of machine that
replays it:

  python -m brpc_tpu_torch.tools.make_golden_capture [--out PATH]
      [--seconds 4.0]
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

from brpc_tpu_torch.rpc import Server, set_flag
from brpc_tpu_torch.rpc import capture as cap

REPO = pathlib.Path(__file__).resolve().parent.parent.parent
DEFAULT_OUT = REPO / "build" / "golden_mixed.cap"

RECORD_SECS = 4.0
BULK_BYTES = 4 << 20
QOS_SPEC = "fg:weight=8,limit=16;bulk:weight=1,limit=64;*:limit=10000"
QOS_LANES = 4

BULK_CODE = """
import time
from brpc_tpu_torch.rpc import Batch, Channel
ch = Channel({addr!r}, timeout_ms=60000, connection_type='pooled',
             qos_tenant='bulk', qos_priority=3)
b = Batch(ch)
buf = b'b' * {bulk_bytes}
end = time.time() + {secs}
next_t = time.time()
pending = 0
while time.time() < end:
    if time.time() >= next_t and pending < 4:
        b.submit('Echo.Echo', [buf], timeout_ms=60000)
        pending += 1
        next_t += 0.1
    pending -= len(b.poll(max_n=8, timeout_ms=10))
while pending > 0:
    got = len(b.poll(max_n=8, timeout_ms=1000))
    if not got:
        break
    pending -= got
b.close()
ch.close()
"""

FG_CODE = """
import time
from brpc_tpu_torch.rpc import Channel, deadline_scope
ch = Channel({addr!r}, timeout_ms=5000, qos_tenant='fg', qos_priority=0)
buf = b'x' * 1024
end = time.time() + {secs}
i = 0
while time.time() < end:
    try:
        if i % 5 == 0:
            with deadline_scope(500):
                ch.call('Echo.Echo', buf)
        else:
            ch.call('Echo.Echo', buf)
    except Exception:
        pass
    i += 1
    time.sleep(0.002)
ch.close()
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="capture file to write (default: %(default)s)")
    ap.add_argument("--seconds", type=float, default=RECORD_SECS,
                    help="length of the recorded window")
    args = ap.parse_args(argv)
    out_path = pathlib.Path(args.out).resolve()
    if out_path == (REPO / "tests" / "data" / "golden_mixed.cap"):
        raise SystemExit("the reference's golden capture is not ours to "
                         "overwrite: pass another --out")
    out_path.parent.mkdir(parents=True, exist_ok=True)

    set_flag("trpc_qos_lanes", str(QOS_LANES))
    srv = Server()
    srv.register_native_echo("Echo.Echo")
    srv.set_qos(QOS_SPEC)
    srv.start(0)
    addr = f"127.0.0.1:{srv.port}"

    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")

    # Warm the server (connections, lanes, stripe pools) BEFORE arming
    # capture so the golden window is steady-state.
    warm = subprocess.run(
        [sys.executable, "-c",
         FG_CODE.format(addr=addr, secs=1.0)], env=env, timeout=60)
    if warm.returncode != 0:
        raise RuntimeError("warm-up sender failed")

    cap.enable_capture(True)
    cap.reset_capture()
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         BULK_CODE.format(addr=addr, bulk_bytes=BULK_BYTES,
                          secs=args.seconds)], env=env)]
    procs += [subprocess.Popen(
        [sys.executable, "-c", FG_CODE.format(addr=addr, secs=args.seconds)],
        env=env) for _ in range(2)]
    try:
        for p in procs:
            p.wait(timeout=120)
            if p.returncode != 0:
                raise RuntimeError("a golden sender failed")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    time.sleep(0.2)
    n = cap.dump(str(out_path))
    summary = cap.summary()["summary"]
    cap.enable_capture(False)
    srv.stop()

    print(json.dumps({
        "path": str(out_path),
        "records": n,
        "window_us": summary.get("window_us"),
        "tenants": {t: {"kept": d["kept"], "p99_us": d["p99_us"],
                        "est_rate_rps": round(d["est_rate_rps"], 1)}
                    for t, d in summary.get("tenants", {}).items()},
    }, indent=2))
    # The reference's 500 records for its 4 s window, pro rata.
    if n < 500 * args.seconds / RECORD_SECS:
        print("WARNING: thin capture — regenerate on a quieter box",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
