"""Multi-process load orchestrator — the 100k-connection front door
proof; port of tools/load_orchestrator.py.  Host-only: its roles drive
the shared native runtime through the port's `rpc` package, and every
process it starts is this module again (`--role ...`).

Drives ONE native server (REUSEPORT-sharded acceptors, multiple epoll
dispatchers, optional per-tenant QoS) to six-figure concurrent
connection counts with mixed traffic: every connection completes a 1KB
echo, every Nth additionally moves a multi-MB payload.  Reports
connections established, echoes verified, wedged connections (connected
but never answered) and the server's socket-map memory
(rpc_socket_live + VmRSS).

Workers speak the tstd wire format directly over raw nonblocking
sockets — a per-connection Channel would measure the CLIENT library, and
100k fibers of it; raw sockets measure the server, which is the point.
Each worker binds a distinct loopback source address (127.0.0.X) so the
~49k-ephemeral-port budget is per worker, not global.

Usage:
  python -m brpc_tpu_torch.tools.load_orchestrator          # 100k conns
  python -m brpc_tpu_torch.tools.load_orchestrator --smoke  # ~2k, bounded
  python -m brpc_tpu_torch.tools.load_orchestrator --conns 50000 \
      --workers 8 --json
  python -m brpc_tpu_torch.tools.load_orchestrator --rolling-restart
  python -m brpc_tpu_torch.tools.load_orchestrator --infer [--smoke]

Exit 0 iff every attempted connection connected and echoed (0 wedged) at
the achieved scale.  If the box's fd limits cannot cover the target even
for root, the run scales down to the documented maximum and says so in
the report (fd_limited: true) rather than failing — per-box ceilings are
a fact to report, not an error.
"""

from __future__ import annotations

import argparse
import errno
import json
import os
import pathlib
import random
import resource
import selectors
import socket
import struct
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent.parent.parent
MODULE = "brpc_tpu_torch.tools.load_orchestrator"


def _env() -> dict:
    """The environment of every role process: this checkout importable."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env

# ---- tstd wire format (cpp/net/protocol.cc) ------------------------------

_MAGIC = b"TRP1"


def pack_request(cid: int, method: str, payload: bytes,
                 tenant: bytes = b"", priority: int = 0) -> bytes:
    m = method.encode()
    meta = bytearray()
    meta += struct.pack("<BQII", 0, cid, 0, 0)      # type, cid, err, attach
    meta += struct.pack("<QBQ", 0, 0, 0)            # stream, sflags, ack
    meta += struct.pack("<I", len(m)) + m           # method
    meta += struct.pack("<I", 0)                    # error_text
    if tenant or priority:
        # Optional tail: each later group implies every earlier one
        # (trace 24B, compress/checksum 6B, streams 4B, stripe 24B, qos).
        meta += b"\0" * 24
        meta += b"\0" * 6
        meta += struct.pack("<I", 0)
        meta += b"\0" * 24
        meta += struct.pack("<BH", priority, len(tenant)) + tenant
    return (_MAGIC + struct.pack("<IQ", len(meta), len(payload)) +
            bytes(meta) + payload)


def parse_response(buf: bytearray):
    """Returns (cid, err_code, payload_len, frame_len) or None if
    incomplete."""
    if len(buf) < 16:
        return None
    if buf[:4] != _MAGIC:
        raise ValueError("bad magic from server")
    meta_len, payload_len = struct.unpack_from("<IQ", buf, 4)
    frame = 16 + meta_len + payload_len
    if len(buf) < frame:
        return None
    _type, cid, err = struct.unpack_from("<BQI", buf, 16)
    return cid, err, payload_len, frame


# ---- capture-shape sampling ----------------------------------------------
#
# --shape <capture>: drive the connection storm with a RECORDED traffic
# shape instead of the fixed small/big split — each connection samples
# its (request size, tenant, priority) from the empirical distribution
# in a trpc capture file (brpc_tpu_torch/rpc/capture.py format: recordio
# envelope, "TRPCCAP1" header record, packed metadata records).  The
# reader is standalone on purpose: workers speak raw sockets and must
# not import the RPC package.

_CAP_RECORD = struct.Struct("<BqqQQQQiIIIBBB")  # capture.py RECORD_STRUCT


def load_shape(path: str) -> list:
    """Returns [(request_bytes, tenant: bytes, priority), ...] in
    recorded arrival order."""
    triples = []
    with open(path, "rb") as f:
        first = True
        while True:
            head = f.read(8)
            if len(head) < 8:
                break
            if head[:4] != b"TREC":
                raise ValueError(f"bad recordio magic in {path}")
            (length,) = struct.unpack("<I", head[4:])
            payload = f.read(length)
            if len(payload) < length:
                break
            if first:
                first = False
                if not payload.startswith(b"TRPCCAP1"):
                    raise ValueError(f"{path} is not a capture file")
                continue
            if not payload or payload[0] != 1:  # record version gate
                continue
            (_v, _am, _aw, _tid, _ps, req, _resp, _st, _q, _h, _b,
             prio, mlen, tlen) = _CAP_RECORD.unpack_from(payload)
            off = _CAP_RECORD.size + mlen
            triples.append((req, payload[off:off + tlen], prio))
    if not triples:
        raise ValueError(f"no records in capture {path}")
    return triples


# ---- fd limits -----------------------------------------------------------

def raise_fd_limit(want: int) -> int:
    """Raises RLIMIT_NOFILE toward `want`; returns the achieved soft
    limit.  Root may exceed the hard limit (CAP_SYS_RESOURCE); plain
    users get min(want, hard)."""
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    for target in (want, hard):
        if target <= soft:
            break
        try:
            resource.setrlimit(resource.RLIMIT_NOFILE,
                               (target, max(target, hard)))
            break
        except (ValueError, OSError):
            continue
    return resource.getrlimit(resource.RLIMIT_NOFILE)[0]


# ---- server role ---------------------------------------------------------

def run_server(args) -> None:
    raise_fd_limit(args.conns + 1024)
    from brpc_tpu_torch.rpc import Server, observe, set_flag

    # Before ANY socket exists: the dispatcher count latches at the first
    # registration.
    set_flag("trpc_event_dispatchers", str(args.dispatchers))
    if args.qos_lanes:
        set_flag("trpc_qos_lanes", str(args.qos_lanes))
    srv = Server()
    srv.register_native_echo("Echo.Echo")
    if args.qos:
        srv.set_qos(args.qos)
    srv.set_reuseport_shards(args.shards)
    srv.start(0)
    print(json.dumps({"port": srv.port}), flush=True)

    def stats() -> dict:
        vars_ = observe.Vars.dump()
        return {
            "live_sockets": vars_.get("rpc_socket_live", 0),
            "rss_kb": vars_.get("process_memory_rss_kb", 0),
            "accept_counts": srv.accept_counts(),
            "qos_shed_total": vars_.get("qos_shed_total", 0),
        }

    for line in sys.stdin:
        cmd = line.strip()
        if cmd == "stats":
            print(json.dumps(stats()), flush=True)
        elif cmd == "quit":
            break
    print(json.dumps(stats()), flush=True)
    srv.stop()


# ---- worker role ---------------------------------------------------------

class Conn:
    __slots__ = ("sock", "state", "buf", "out", "echoed", "big", "shape")

    def __init__(self, sock, big: bool, shape=None):
        self.sock = sock
        self.state = "connecting"
        self.buf = bytearray()
        self.out = b""
        self.echoed = 0
        self.big = big
        self.shape = shape  # (request_bytes, tenant, priority) or None


def run_worker(args) -> None:
    raise_fd_limit(args.conns + 512)
    addr = (args.host, args.port)
    src_ip = f"127.0.0.{args.index + 2}"
    bind_ok = True
    probe = socket.socket()
    try:
        probe.bind((src_ip, 0))
    except OSError:
        bind_ok = False  # box without loopback aliasing: share 127.0.0.1
    finally:
        probe.close()

    small = b"x" * args.small_bytes
    big = b"y" * args.big_bytes
    # Recorded traffic shape: each connection draws its (size, tenant,
    # priority) from the capture's empirical distribution.  Seeded per
    # worker index so a re-run offers the same sampled mix.
    shape = load_shape(args.shape) if args.shape else None
    shape_rng = random.Random(args.index + 1)
    shape_cache: dict[int, bytes] = {}
    shape_mix: dict[str, int] = {}
    sel = selectors.DefaultSelector()
    conns: dict[int, Conn] = {}
    failures = {"connect": 0, "reset": 0, "proto": 0}
    attempted = 0
    deadline = time.monotonic() + args.timeout

    def open_one(i: int) -> None:
        nonlocal attempted
        attempted += 1
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setblocking(False)
        if bind_ok:
            s.bind((src_ip, 0))
        triple = None
        if shape is not None:
            triple = shape[shape_rng.randrange(len(shape))]
            tname = triple[1].decode(errors="replace")
            shape_mix[tname] = shape_mix.get(tname, 0) + 1
        c = Conn(s, args.big_every > 0 and i % args.big_every == 0, triple)
        try:
            rc = s.connect_ex(addr)
        except OSError:
            failures["connect"] += 1
            s.close()
            return
        if rc not in (0, errno.EINPROGRESS, errno.EWOULDBLOCK):
            failures["connect"] += 1
            s.close()
            return
        conns[s.fileno()] = c
        sel.register(s, selectors.EVENT_WRITE, c)

    def start_request(c: Conn) -> None:
        if c.shape is not None:
            size, tenant, priority = c.shape
            size = min(size, args.big_bytes)  # memory backstop
            payload = shape_cache.get(size)
            if payload is None:
                payload = shape_cache[size] = b"z" * size
            c.out = pack_request(1, "Echo.Echo", payload,
                                 tenant=tenant, priority=priority)
        else:
            payload = big if c.big else small
            c.out = pack_request(1, "Echo.Echo", payload,
                                 tenant=args.tenant.encode(),
                                 priority=args.priority)
        sel.modify(c.sock, selectors.EVENT_WRITE | selectors.EVENT_READ, c)

    def pump(c: Conn) -> None:
        # Write what we can, then read what's there.
        try:
            while c.out:
                n = c.sock.send(c.out[:1 << 18])
                if n <= 0:
                    break
                c.out = c.out[n:]
        except BlockingIOError:
            pass
        except OSError:
            drop(c, "reset")
            return
        if not c.out and c.state == "sending":
            c.state = "reading"
            sel.modify(c.sock, selectors.EVENT_READ, c)

    def drop(c: Conn, why: str) -> None:
        failures[why] += 1
        try:
            sel.unregister(c.sock)
        except (KeyError, ValueError):
            pass
        conns.pop(c.sock.fileno(), None)
        c.sock.close()

    next_open = 0
    while time.monotonic() < deadline:
        # Ramp: open in bounded batches so SYN bursts stay inside the
        # listeners' backlog.
        opened_this_tick = 0
        while (next_open < args.conns and len(conns) < args.conns and
               opened_this_tick < args.ramp_batch):
            open_one(next_open)
            next_open += 1
            opened_this_tick += 1
        events = sel.select(timeout=0.05)
        for key, mask in events:
            c: Conn = key.data
            if c.state == "connecting":
                err = c.sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
                if err != 0:
                    drop(c, "connect")
                    continue
                c.state = "sending"
                start_request(c)
                pump(c)
                continue
            if mask & selectors.EVENT_WRITE and c.out:
                pump(c)
            if mask & selectors.EVENT_READ:
                try:
                    data = c.sock.recv(1 << 18)
                except BlockingIOError:
                    continue
                except OSError:
                    drop(c, "reset")
                    continue
                if not data:
                    drop(c, "reset")
                    continue
                c.buf += data
                try:
                    while (r := parse_response(c.buf)) is not None:
                        _cid, err, _plen, frame = r
                        del c.buf[:frame]
                        if err != 0:
                            drop(c, "proto")
                            break
                        c.echoed += 1
                        c.state = "idle"
                        # Hold the conn open, off the selector: its part
                        # of the concurrency high-water is done.
                        sel.unregister(c.sock)
                        break
                except ValueError:
                    drop(c, "proto")
        if next_open >= args.conns:
            done = sum(1 for c in conns.values() if c.echoed > 0)
            if done == len(conns):
                break

    connected = len(conns)
    echoed = sum(1 for c in conns.values() if c.echoed > 0)
    wedged = connected - echoed
    report = {
        "index": args.index,
        "attempted": attempted,
        "connected": connected,
        "echoed": echoed,
        "wedged": wedged,
        "failures": failures,
        "src_bind": bind_ok,
    }
    if shape is not None:
        report["shape_mix"] = shape_mix
    print(json.dumps(report), flush=True)
    if args.hold > 0:
        time.sleep(args.hold)  # keep sockets open while the parent polls
    for c in conns.values():
        c.sock.close()


# ---- rolling restart -----------------------------------------------------
#
# Zero-downtime drain + hot restart of one node in a 3-node cluster,
# driven end to end: a hub process hosts the naming + KV registries,
# node processes announce themselves and publish KV blocks, worker
# processes drive mixed 1KB + striped load through
# ClusterChannel("naming://...") under deterministic subsetting
# (trpc_cluster_subset_size — the fd-cap discipline), and a KV puller
# fetches the nodes' blocks with naming-aware re-resolution.  Mid-run,
# node 0 drains: its announcement withdraws (watchers re-balance), its
# KV blocks tombstone, its SO_REUSEPORT listeners hand off to a fresh
# successor process which re-announces under a newer epoch and
# re-publishes the blocks under a newer generation.  The report stamps
# client-visible errors (must be 0), steady vs drain-window p99, and
# stale KV admits (must be 0).

def _percentile(vals: list, p: float) -> float:
    if not vals:
        return 0.0
    s = sorted(vals)
    return s[min(len(s) - 1, int(len(s) * p))]


def _block_bytes(bid: int, gen: int, n: int) -> bytes:
    """Deterministic block content with a (bid, gen) header: a fetch
    that returns a LOWER embedded generation than one already observed
    is a stale admit — the thing the generation fence must prevent."""
    hdr = struct.pack("<QQ", bid, gen)
    pat = bytes((i * 131 + bid * 7 + gen * 13) % 251 for i in range(256))
    body = (pat * ((n - 16) // 256 + 1))[:n - 16]
    return hdr + body


_PREFIX_BT = 128  # tokens per prefix block (trpc_kv_prefix_block_tokens)


def _prefix_tokens(blocks: int) -> list:
    """The cluster-shared prompt prefix: fixed token ids, so every node
    derives the same chain keys (and the successor re-derives them)."""
    return [42_000_000 + j for j in range(blocks * _PREFIX_BT)]


def _prefix_content(key, n: int) -> bytes:
    """Block bytes derived from the CHAIN KEY alone: every publisher
    regenerates identical content -> one content hash per chain key, a
    replica per node.  A fetched block that does not byte-match this
    recipe is a stale admit."""
    salt = key[1] & 0xFFFFFFFF
    pat = bytes((salt + i * 131) % 251 for i in range(256))
    return (pat * ((n + 255) // 256))[:n]


def _publish_prefix_chain(srv_port: int, hub_addr: str, blocks: int,
                          block_bytes: int, min_gen: int = 0) -> int:
    """Publishes the shared prompt-prefix chain into this node's
    content-addressed store and registers each block's replica at the
    hub.  Returns the highest accepted generation."""
    from brpc_tpu_torch.rpc import Channel, kv

    addr = f"127.0.0.1:{srv_port}"
    tokens = _prefix_tokens(blocks)
    keys = kv.prefix_chain(tokens, _PREFIX_BT)
    reg = kv.KvRegistryClient(Channel(hub_addr, timeout_ms=5000),
                              owns_channel=True)
    top = 0
    try:
        for d, key in enumerate(keys):
            span = tokens[d * _PREFIX_BT:(d + 1) * _PREFIX_BT]
            meta, _fresh = kv.prefix_publish(
                key, d, _prefix_content(key, block_bytes), span,
                lease_ms=600000, node=addr, min_generation=min_gen)
            gen, _fresh_reg = reg.put_prefix(meta, lease_ms=600000)
            top = max(top, gen)
    finally:
        reg.close()
    return top


def run_rr_hub(args) -> None:
    from brpc_tpu_torch.rpc import Server

    srv = Server()
    srv.enable_naming_registry()
    srv.enable_kv_registry()
    srv.start(0)
    print(json.dumps({"port": srv.port}), flush=True)
    for line in sys.stdin:
        if line.strip() == "quit":
            break
    srv.close()


def _publish_blocks(srv_port: int, hub_addr: str, index: int, blocks: int,
                    block_bytes: int, gen: int, min_generation: int = 0):
    """Publish this node's blocks (ids index*100+i) + register at the
    hub.  Returns (pages, registry_client) — both must stay alive."""
    from brpc_tpu_torch.rpc import Channel, RmaBuffer, kv

    addr = f"127.0.0.1:{srv_port}"
    pages = RmaBuffer(max(blocks * block_bytes, 1 << 16))
    view = memoryview(pages.view).cast("B")
    reg = kv.KvRegistryClient(Channel(hub_addr, timeout_ms=5000),
                              owns_channel=True)
    for i in range(blocks):
        bid = (index + 1) * 100 + i  # ids start at 100: block 0 is reserved
        view[i * block_bytes:(i + 1) * block_bytes] = \
            _block_bytes(bid, gen, block_bytes)
        m = kv.publish(bid, pages, offset=i * block_bytes,
                       length=block_bytes, lease_ms=600000, node=addr,
                       min_generation=min_generation)
        reg.register(m, lease_ms=600000)
    return pages, reg


def run_rr_node(args) -> None:
    from brpc_tpu_torch.rpc import Server

    hub_addr = f"127.0.0.1:{args.port}"
    srv = Server()
    srv.register_native_echo("Echo.Echo")
    srv.enable_kv_store()
    srv.start(0)
    srv.announce(hub_addr, "echo")
    pages, reg = _publish_blocks(srv.port, hub_addr, args.index,
                                 args.blocks, args.block_bytes, gen=1)
    # Every node also offers the cluster-shared prompt prefix: identical
    # content => the registry folds the offers into one record per chain
    # key with an N-node replica set.
    _publish_prefix_chain(srv.port, hub_addr, args.blocks,
                          args.block_bytes)
    print(json.dumps({"port": srv.port}), flush=True)
    for line in sys.stdin:
        cmd = line.strip().split()
        if not cmd:
            continue
        if cmd[0] == "drain":
            ok = srv.drain(deadline_ms=20000, handoff_path=cmd[1])
            print(json.dumps({"drained": ok}), flush=True)
        elif cmd[0] == "quit":
            break
    reg.close()
    pages.free()
    srv.close()


def run_rr_succ(args) -> None:
    """Hot-restart successor: adopts the draining node's listeners,
    re-announces the endpoint under a newer epoch, and re-publishes its
    KV blocks under a newer generation (fresh pid => fresh rkeys; the
    min_generation floor keeps the registry's zombie fence satisfied)."""
    from brpc_tpu_torch.rpc import Channel, Server, kv

    hub_addr = f"127.0.0.1:{args.port}"
    srv = Server()
    srv.register_native_echo("Echo.Echo")
    srv.enable_kv_store()
    srv.start_from_handoff(args.handoff, 30000)
    srv.announce(hub_addr, "echo")
    probe = kv.KvRegistryClient(Channel(hub_addr, timeout_ms=5000),
                                owns_channel=True)
    old_gens = {}
    for i in range(args.blocks):
        bid = (args.index + 1) * 100 + i
        try:
            old_gens[bid] = probe.lookup(bid).generation
        except kv.KvError:
            old_gens[bid] = 1
    probe.close()
    min_gen = max(old_gens.values()) + 1
    pages, reg = _publish_blocks(srv.port, hub_addr, args.index,
                                 args.blocks, args.block_bytes,
                                 gen=min_gen, min_generation=min_gen)
    # Re-home the drained node's prefix replicas: the
    # registry's per-node generation fence makes the dead pid's records
    # zombies, so the successor's offers must clear it — probe the
    # replica set for this endpoint's last generation and publish above
    # it.  Same content, same hashes: only the replica's (gen, rkey)
    # re-homes; the other nodes' replicas are untouched.
    pprobe = kv.KvRegistryClient(Channel(hub_addr, timeout_ms=5000),
                                 owns_channel=True)
    my_addr = f"127.0.0.1:{srv.port}"
    prefix_fence = 1
    try:
        for m in pprobe.match(kv.prefix_chain(
                _prefix_tokens(args.blocks), _PREFIX_BT)):
            if m.node == my_addr:
                prefix_fence = max(prefix_fence, m.generation)
    finally:
        pprobe.close()
    prefix_gen = _publish_prefix_chain(srv.port, hub_addr, args.blocks,
                                       args.block_bytes,
                                       min_gen=prefix_fence + 1)
    print(json.dumps({"adopted_port": srv.port, "generation": min_gen,
                      "prefix_generation": prefix_gen}),
          flush=True)
    for line in sys.stdin:
        if line.strip() == "quit":
            break
    reg.close()
    pages.free()
    srv.close()


def run_rr_worker(args) -> None:
    from brpc_tpu_torch.rpc import ClusterChannel, set_flag

    if args.subset > 0:
        # fd-budget discipline (mandatory under this box's 20k fd cap at
        # real scale): each worker holds channels to `subset` of the
        # cluster, rendezvous-picked per pid.
        set_flag("trpc_cluster_subset_size", str(args.subset))
    ch = ClusterChannel(f"naming://127.0.0.1:{args.port}/echo", lb="rr",
                        timeout_ms=5000, max_retry=2,
                        refresh_interval_ms=500)
    small = b"x" * args.small_bytes
    big = b"y" * args.big_bytes
    samples = []  # (wall_s, latency_us, ok)
    errors = 0
    i = 0
    end = time.time() + args.seconds
    while time.time() < end:
        payload = big if args.big_every > 0 and i % args.big_every == 0 \
            else small
        w = time.time()
        t0 = time.perf_counter()
        try:
            ok = len(ch.call("Echo.Echo", payload)) == len(payload)
        except Exception:
            ok = False
        lat_us = (time.perf_counter() - t0) * 1e6
        if not ok:
            errors += 1
        samples.append((w, lat_us, ok))
        i += 1
    ch.close()
    # The drain window is known only after the fact: the orchestrator
    # writes it once the drain cycle completes.  WAIT for it (bounded) —
    # reporting without it would make the drain-window p99 acceptance
    # pass vacuously whenever the drain outlasts the load.
    window = None
    wait_deadline = time.time() + 30
    while window is None and time.time() < wait_deadline:
        try:
            with open(args.window_file) as f:
                window = json.load(f)
        except (OSError, json.JSONDecodeError, TypeError):
            time.sleep(0.1)
    steady = [lat for w, lat, _ in samples
              if window is None or not (
                  window["start"] <= w <= window["end"])]
    drained = [lat for w, lat, _ in samples
               if window is not None and
               window["start"] <= w <= window["end"]]
    print(json.dumps({
        "index": args.index,
        "calls": len(samples),
        "errors": errors,
        "steady_p99_us": round(_percentile(steady, 0.99)),
        "drain_p99_us": round(_percentile(drained, 0.99)),
        "drain_samples": len(drained),
    }), flush=True)


def run_rr_kvpuller(args) -> None:
    """Fetches every node's blocks in a loop, verifying the embedded
    (bid, gen) header.  Transient failures during the drain window are
    retried (and counted); a fetch whose embedded generation moves
    BACKWARD is a stale admit — the acceptance criterion is zero."""
    from brpc_tpu_torch.rpc import kv

    hub_addr = f"127.0.0.1:{args.port}"
    cli = kv.KvClient(hub_addr, use_shm=False, timeout_ms=5000,
                      naming_addr=hub_addr, naming_service="echo")
    bids = [(n + 1) * 100 + i for n in range(args.nodes)
            for i in range(args.blocks)]
    fetches = 0
    transient = 0
    stale_admits = 0
    mismatches = 0
    max_gen = {}
    # Prefix-cache lane: the cluster-shared prompt prefix is
    # matched and fetched continuously through the replica-set path.
    # Content addressing makes staleness structural — a served block
    # that does not byte-match the chain-key recipe is a stale admit,
    # and a replica whose generation moves backward in the match view
    # is a fence regression.  Both must stay at zero across the drain.
    ptokens = _prefix_tokens(args.blocks)
    pkeys = kv.prefix_chain(ptokens, _PREFIX_BT)
    pwant = [_prefix_content(k, args.block_bytes) for k in pkeys]
    prefix_fetches = 0
    prefix_stale_admits = 0
    prefix_short = 0
    prefix_transient = 0
    prefix_gen_regressions = 0
    prefix_takeover_gen = 0
    prefix_replicas_peak = 0
    pgen = {}
    end = time.time() + args.seconds
    while time.time() < end:
        try:
            groups = cli.match_prefix(ptokens)
            blocks = cli.fetch_prefix(ptokens)
        except Exception:
            prefix_transient += 1
            groups, blocks = [], []
        prefix_replicas_peak = max(prefix_replicas_peak,
                                   sum(len(g) for g in groups))
        for g in groups:
            for m in g:
                kk = (m.key_hi, m.key_lo, m.node)
                if m.generation < pgen.get(kk, 0):
                    prefix_gen_regressions += 1
                pgen[kk] = max(pgen.get(kk, 0), m.generation)
                prefix_takeover_gen = max(prefix_takeover_gen,
                                          m.generation)
        for d, b in enumerate(blocks):
            prefix_fetches += 1
            if b != pwant[d]:
                prefix_stale_admits += 1
        if blocks and len(blocks) < len(pkeys):
            prefix_short += 1  # every replica of a block failed whole
        for bid in bids:
            if time.time() >= end:
                break
            try:
                data = cli.fetch(bid)
            except Exception:
                transient += 1
                time.sleep(0.05)
                continue
            fetches += 1
            got_bid, got_gen = struct.unpack_from("<QQ", data)
            if got_bid != bid or \
                    data != _block_bytes(bid, got_gen, len(data)):
                mismatches += 1
            if got_gen < max_gen.get(bid, 0):
                stale_admits += 1  # generation moved BACKWARD: stale
            max_gen[bid] = max(max_gen.get(bid, 0), got_gen)
    cli.close()
    print(json.dumps({
        "fetches": fetches,
        "transient_retries": transient,
        "stale_admits": stale_admits,
        "mismatches": mismatches,
        "reresolves": cli.node_reresolves,
        "takeover_gens": {str(k): v for k, v in max_gen.items()
                          if v > 1},
        "prefix_fetches": prefix_fetches,
        "prefix_stale_admits": prefix_stale_admits,
        "prefix_short_reads": prefix_short,
        "prefix_transient": prefix_transient,
        "prefix_gen_regressions": prefix_gen_regressions,
        "prefix_takeover_gen": prefix_takeover_gen,
        "prefix_replicas_peak": prefix_replicas_peak,
    }), flush=True)


# ---- streamed-inference roles --------------------------------------------
#
# The 100k-LOGICAL-STREAM proof: the conn orchestrator above spends one fd
# per connection, so its scale is fd-bound; the inference front door
# multiplexes thousands of token streams per connection, so the SAME box
# (20k fd cap) holds 100k+ concurrent completions.  Four phases against
# one serving process:
#
#   ramp     hold-workers submit completions against a parked scheduler
#            (step_us maxed, batch_max=1): every accepted submit holds a
#            live logical stream while the server's fd count stays at a
#            handful of connections.  Peak streams + /proc fd count are
#            the headline numbers.
#   drain    flip the RELOADABLE knobs (step_us=0 drain mode, batch_max
#            wide) and every held stream must decode to EOS — zero
#            wedged at scale.
#   serving  steady-state TTFT/TPOT with a hot prompt pool through the
#            prefix cache (cached prompt blocks skip recompute).
#   overload hog tenant offers ~2x the admission cap; every hog failure
#            must be TYPED (2005/2007) and the in-SLO victim tenant's
#            TPOT p99 must stay within 2x its unloaded value.

def run_infer_server(args) -> None:
    raise_fd_limit(args.fd_cap + 8192)
    from brpc_tpu_torch.rpc import Server, observe, set_flag

    set_flag("trpc_event_dispatchers", str(args.dispatchers))
    for spec in args.flags.split(","):
        if spec:
            k, v = spec.split("=", 1)
            set_flag(k, v)
    srv = Server()
    if args.qos:
        srv.set_qos(args.qos)
    srv.enable_infer(prefix_cache=True)
    srv.start(0)
    print(json.dumps({"port": srv.port, "pid": os.getpid()}), flush=True)

    def stats() -> dict:
        d = srv.infer_dump()
        vars_ = observe.Vars.dump()
        # The fd-cap proof: every open fd of the SERVING process while
        # it holds the full stream population.
        d["fds"] = len(os.listdir("/proc/self/fd"))
        d["rss_kb"] = vars_.get("process_memory_rss_kb", 0)
        d["live_sockets"] = vars_.get("rpc_socket_live", 0)
        return d

    for line in sys.stdin:
        parts = line.strip().split(" ", 1)
        if parts[0] == "stats":
            print(json.dumps(stats()), flush=True)
        elif parts[0] == "flags" and len(parts) == 2:
            # Reposture between phases without restarting (every
            # trpc_infer_* knob is reloadable).
            for spec in parts[1].split(","):
                k, v = spec.split("=", 1)
                set_flag(k, v)
            print(json.dumps({"ok": True}), flush=True)
        elif parts[0] == "quit":
            break
    print(json.dumps(stats()), flush=True)
    srv.close()


def run_infer_hold(args) -> None:
    """Submits --streams completions over --channels connections and
    HOLDS them (the scheduler is parked), then drains every one to EOS
    on the orchestrator's signal.  Token ids are worker-unique so no
    prompt accidentally prefix-matches another's."""
    from brpc_tpu_torch.rpc import Channel, InferClient

    addr = f"{args.host}:{args.port}"
    chans = [Channel(addr, timeout_ms=600000)
             for _ in range(max(1, args.channels))]
    clients = [InferClient(ch) for ch in chans]
    held = []
    failed = 0
    base = (args.index + 1) * 10_000_000
    for i in range(args.streams):
        prompt = [base + i * 4 + j for j in range(4)]
        try:
            # A 10-minute budget: the submit's wire deadline is the
            # stream's cancel budget, and the hold phase must outlive
            # the whole ramp across every worker.
            held.append(clients[i % len(clients)].submit(
                prompt, max_new_tokens=2, publish=False,
                timeout_ms=600000))
        except Exception:
            failed += 1
    print(json.dumps({"submitted": len(held), "failed": failed}),
          flush=True)

    sys.stdin.readline()  # orchestrator says the scheduler is draining
    eos = cancelled = errors = 0
    for comp in held:
        try:
            last = None
            for rec in comp.records(timeout_ms=300000):
                last = rec
            if last is not None and last.eos:
                eos += 1
            elif comp.cancelled:
                cancelled += 1
            else:
                errors += 1
        except Exception:
            errors += 1
        comp.close()
    print(json.dumps({"eos": eos, "cancelled": cancelled,
                      "errors": errors}), flush=True)
    for ch in chans:
        ch.close()


def run_infer_serve(args) -> None:
    """Closed-loop completion traffic for --seconds: submit from a hot
    prompt pool (shared across workers, so the prefix cache converges),
    consume every token, record client-observed TTFT and TPOT."""
    from brpc_tpu_torch.rpc import (Channel, DeadlineExpiredError, InferClient,
                              OverloadedError)

    ch = Channel(f"{args.host}:{args.port}", timeout_ms=30000)
    cli = InferClient(ch, tenant=args.tenant, priority=args.priority)
    rng = random.Random(args.index + 7)
    pool = [[1000 + p * 1000 + t for t in range(args.prompt_tokens)]
            for p in range(args.pool)]
    ttft, tpot = [], []
    done = cancelled = typed = untyped = 0
    end = time.monotonic() + args.seconds
    while time.monotonic() < end:
        prompt = pool[rng.randrange(len(pool))]
        t0 = time.monotonic()
        try:
            comp = cli.submit(prompt, max_new_tokens=args.max_new,
                              timeout_ms=20000)
        except (OverloadedError, DeadlineExpiredError):
            typed += 1
            time.sleep(0.002)
            continue
        except Exception:
            untyped += 1
            continue
        prev = None
        try:
            for _rec in comp.records(timeout_ms=20000):
                now = time.monotonic()
                if prev is None:
                    ttft.append((now - t0) * 1e6)
                else:
                    tpot.append((now - prev) * 1e6)
                prev = now
            if comp.cancelled:
                cancelled += 1
            else:
                done += 1
        except Exception:
            untyped += 1
        comp.close()
    ch.close()
    print(json.dumps({"done": done, "cancelled": cancelled,
                      "typed_errors": typed, "untyped_errors": untyped,
                      "ttft_us": [round(v) for v in ttft],
                      "tpot_us": [round(v) for v in tpot]}), flush=True)


def run_infer_flood(args) -> None:
    """The hog tenant: tries to hold --hold-streams concurrent
    completions (sized ~2x the admission cap by the orchestrator) for
    --seconds.  Every rejection must be TYPED — an untyped failure here
    is an isolation bug, not load."""
    from brpc_tpu_torch.rpc import (Channel, DeadlineExpiredError, InferClient,
                              OverloadedError)
    from brpc_tpu_torch.rpc.infer import CancelledError

    ch = Channel(f"{args.host}:{args.port}", timeout_ms=30000)
    cli = InferClient(ch, tenant=args.tenant, priority=args.priority)
    held = []
    admitted = typed = untyped = 0
    base = 900_000_000 + args.index * 1_000_000
    n = 0
    end = time.monotonic() + args.seconds
    while time.monotonic() < end:
        if len(held) < args.hold_streams:
            n += 1
            prompt = [base + n * 4 + j for j in range(4)]
            try:
                held.append(cli.submit(prompt, max_new_tokens=4,
                                       publish=False, timeout_ms=15000))
                admitted += 1
            except (OverloadedError, DeadlineExpiredError):
                typed += 1
                time.sleep(0.005)
            except Exception:
                untyped += 1
            continue
        comp = held.pop(0)
        try:
            for _rec in comp.records(timeout_ms=20000):
                pass
        except CancelledError:
            typed += 1  # deadline-reaped mid-decode: typed cancel
        except Exception:
            untyped += 1
        comp.close()
    for comp in held:
        comp.close()
    ch.close()
    print(json.dumps({"admitted": admitted, "typed": typed,
                      "untyped": untyped}), flush=True)


def run_infer_orchestrator(args) -> int:
    env = _env()
    me = ["-m", MODULE]
    t0 = time.monotonic()
    target = args.infer_streams
    per_worker = (target + args.workers - 1) // args.workers
    queue_max = min(1_000_000, target + 1024)

    # Ramp posture: park the scheduler (10s ticks, batch of 1) so every
    # accepted submit HOLDS its stream in the waiting queue.
    ramp_flags = (f"trpc_infer_step_us=10000000,trpc_infer_batch_max=1,"
                  f"trpc_infer_queue_max={queue_max},"
                  f"trpc_infer_prefill_us_per_token=0")
    server = subprocess.Popen(
        [sys.executable, *me, "--role", "infer-server",
         "--dispatchers", str(args.dispatchers),
         "--fd-cap", str(args.fd_cap),
         "--qos", "victim:weight=4;hog:weight=1",
         "--flags", ramp_flags],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env, text=True)
    boot = server.stdout.readline()
    try:
        port = json.loads(boot)["port"]
    except (json.JSONDecodeError, KeyError):
        print(f"infer server failed to start: {boot!r}", file=sys.stderr)
        server.kill()
        return 1

    def ask(cmd: str) -> dict:
        server.stdin.write(cmd + "\n")
        server.stdin.flush()
        return json.loads(server.stdout.readline())

    def spawn_worker(role: str, *extra: str) -> subprocess.Popen:
        return subprocess.Popen(
            [sys.executable, *me, "--role", role, "--host", "127.0.0.1",
             "--port", str(port), *extra],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env,
            text=True)

    # -- phase 1: ramp ----------------------------------------------------
    holders = [spawn_worker("infer-hold", "--index", str(i),
                            "--streams", str(per_worker),
                            "--channels", str(args.channels))
               for i in range(args.workers)]
    ramp = []
    for w in holders:
        line = w.stdout.readline()
        try:
            ramp.append(json.loads(line))
        except json.JSONDecodeError:
            ramp.append({"submitted": 0, "failed": per_worker})
    peak = ask("stats")  # all workers still hold their streams

    # -- phase 2: drain ---------------------------------------------------
    ask("flags trpc_infer_step_us=0,trpc_infer_batch_max=65536")
    for w in holders:
        w.stdin.write("drain\n")
        w.stdin.flush()
    drained = []
    for w in holders:
        line = w.stdout.readline()
        try:
            drained.append(json.loads(line))
        except json.JSONDecodeError:
            drained.append({"eos": 0, "cancelled": 0,
                            "errors": per_worker})
    for w in holders:
        w.wait(timeout=60)
    post_drain = ask("stats")

    submitted = sum(r.get("submitted", 0) for r in ramp)
    submit_failed = sum(r.get("failed", 0) for r in ramp)
    eos = sum(r.get("eos", 0) for r in drained)
    wedged = submitted - eos

    def pctls(rows: list) -> dict:
        ttft = [v for r in rows for v in r.get("ttft_us", [])]
        tpot = [v for r in rows for v in r.get("tpot_us", [])]
        return {
            "done": sum(r.get("done", 0) for r in rows),
            "cancelled": sum(r.get("cancelled", 0) for r in rows),
            "typed_errors": sum(r.get("typed_errors", 0) for r in rows),
            "untyped_errors": sum(r.get("untyped_errors", 0)
                                  for r in rows),
            "ttft_p50_us": round(_percentile(ttft, 0.50)),
            "ttft_p99_us": round(_percentile(ttft, 0.99)),
            "tpot_p50_us": round(_percentile(tpot, 0.50)),
            "tpot_p99_us": round(_percentile(tpot, 0.99)),
            "tpot_samples": len(tpot),
        }

    def serve_phase(n: int, seconds: float, tenant: str) -> list:
        ws = [spawn_worker("infer-serve", "--index", str(i),
                           "--seconds", str(seconds), "--tenant", tenant,
                           "--max-new", str(args.max_new),
                           "--prompt-tokens", str(args.prompt_tokens),
                           "--pool", str(args.pool))
              for i in range(n)]
        rows = []
        for w in ws:
            line = w.stdout.readline()
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                rows.append({"untyped_errors": 1})
            w.wait(timeout=60)
        return rows

    # -- phase 3: steady serving through the prefix cache -----------------
    dump_before = ask("stats")
    ask(f"flags trpc_infer_step_us={args.step_us},"
        f"trpc_infer_batch_max=256,"
        f"trpc_infer_prefill_us_per_token={args.prefill_us},"
        f"trpc_kv_prefix_block_tokens=8")
    serve_rows = pctls(serve_phase(args.serve_workers, args.seconds,
                                   "victim"))
    dump_serve = ask("stats")
    d_cached = dump_serve["bytes_cached"] - dump_before["bytes_cached"]
    d_recomp = (dump_serve["bytes_recomputed"] -
                dump_before["bytes_recomputed"])
    d_tokens = dump_serve["tokens"] - dump_before["tokens"]
    serving = dict(serve_rows)
    serving.update({
        "seconds": args.seconds,
        "tokens_per_s": round(d_tokens / max(args.seconds, 0.001)),
        "recompute_ratio_cached": round(
            d_cached / max(d_cached + d_recomp, 1), 4),
        # Server-side recorders span the ramp/drain phases too (a held
        # stream's TTFT is its park time), so the row's TTFT/TPOT are
        # the client-measured serving-phase numbers above; the recorder
        # count is kept as a liveness cross-check only.
        "server_tpot_count": dump_serve["tpot"]["count"],
    })

    # -- phase 4: overload (hog at ~2x the admission cap) -----------------
    # A coarser decode tick than the serving phase: the ratio compares
    # loaded vs unloaded TPOT, and on small CI boxes a 1ms tick is mostly
    # scheduler oversleep once flooders burn the spare core — which would
    # measure the BOX, not the admission plane.  Both halves of the ratio
    # run the same tick, so the comparison stays honest.
    cap = 16
    ask(f"flags trpc_infer_batch_max=8,trpc_infer_queue_max=8,"
        f"trpc_infer_step_us={args.overload_step_us}")
    unloaded = pctls(serve_phase(max(1, args.serve_workers // 2),
                                 max(3.0, args.seconds / 2), "victim"))
    floods = [spawn_worker("infer-flood", "--index", str(i),
                           "--seconds", str(args.seconds),
                           "--tenant", "hog",
                           "--hold-streams", str(cap))
              for i in range(args.flood_workers)]
    time.sleep(0.5)  # flooders reach the admission wall first
    loaded = pctls(serve_phase(max(1, args.serve_workers // 2),
                               max(3.0, args.seconds / 2), "victim"))
    flood_rows = []
    for w in floods:
        line = w.stdout.readline()
        try:
            flood_rows.append(json.loads(line))
        except json.JSONDecodeError:
            flood_rows.append({"untyped": 1})
        w.wait(timeout=60)
    overload = {
        "admission_cap": cap,
        "step_us": args.overload_step_us,
        "hog_workers": args.flood_workers,
        "hog_hold_target": cap * args.flood_workers,
        "hog_admitted": sum(r.get("admitted", 0) for r in flood_rows),
        "hog_typed": sum(r.get("typed", 0) for r in flood_rows),
        "hog_untyped": sum(r.get("untyped", 0) for r in flood_rows),
        "victim_unloaded_tpot_p99_us": unloaded["tpot_p99_us"],
        "victim_loaded_tpot_p99_us": loaded["tpot_p99_us"],
        "victim_tpot_ratio_p99": round(
            loaded["tpot_p99_us"] / max(unloaded["tpot_p99_us"], 1), 3),
        "victim_done_loaded": loaded["done"],
        "victim_untyped": (unloaded["untyped_errors"] +
                           loaded["untyped_errors"]),
        "shed_total": ask("stats")["shed"],
    }

    final = ask("stats")
    server.stdin.write("quit\n")
    server.stdin.flush()
    json.loads(server.stdout.readline())
    server.wait(timeout=60)

    summary = {
        "workload": "infer_serving",
        "streams_target": target,
        "streams_submitted": submitted,
        "streams_peak": peak["streams_live"],
        "streams_peak_hwm": peak["streams_peak"],
        "submit_failed": submit_failed,
        "eos": eos,
        "wedged": wedged,
        "drain_cancelled": sum(r.get("cancelled", 0) for r in drained),
        "drain_errors": sum(r.get("errors", 0) for r in drained),
        "post_drain_live": post_drain["streams_live"],
        "server_fds_peak": peak["fds"],
        "server_conns_peak": peak["live_sockets"],
        "fd_cap": args.fd_cap,
        "rss_kb_peak": peak["rss_kb"],
        "workers": args.workers,
        "channels_per_worker": args.channels,
        "serving": serving,
        "overload": overload,
        "knobs": {"step_us": args.step_us, "max_new": args.max_new,
                  "prompt_tokens": args.prompt_tokens,
                  "pool": args.pool,
                  "prefill_us_per_token": args.prefill_us,
                  "block_tokens": 8,
                  "dispatchers": args.dispatchers},
        "elapsed_s": round(time.monotonic() - t0, 1),
        "final_cancelled": final["cancelled"],
    }
    print(json.dumps(summary, indent=None if args.json else 2),
          flush=True)
    ok = (submit_failed == 0 and wedged == 0 and
          summary["streams_peak"] >= target and
          summary["server_fds_peak"] < args.fd_cap and
          serving["untyped_errors"] == 0 and
          overload["hog_untyped"] == 0 and
          overload["victim_untyped"] == 0)
    return 0 if ok else 1


def run_rolling_restart(args) -> int:
    raise_fd_limit(8192)
    env = _env()

    def spawn(role: str, *extra: str) -> subprocess.Popen:
        return subprocess.Popen(
            [sys.executable, "-m", MODULE, "--role", role, *extra],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env,
            text=True)

    t_start = time.monotonic()
    hub = spawn("rr-hub")
    hub_port = json.loads(hub.stdout.readline())["port"]

    nodes = []
    for i in range(args.nodes):
        n = spawn("rr-node", "--index", str(i), "--port", str(hub_port),
                  "--blocks", str(args.blocks),
                  "--block-bytes", str(args.block_bytes))
        nodes.append(n)
    node_ports = [json.loads(n.stdout.readline())["port"] for n in nodes]

    tmp = tempfile.gettempdir()
    window_file = os.path.join(tmp, f"trpc_rr_window_{os.getpid()}.json")
    handoff = os.path.join(tmp, f"trpc_rr_handoff_{os.getpid()}.sock")
    try:
        os.unlink(window_file)
    except OSError:
        pass

    workers = [spawn("rr-worker", "--index", str(i),
                     "--port", str(hub_port),
                     "--seconds", str(args.seconds),
                     "--big-every", str(args.big_every),
                     "--big-bytes", str(args.big_bytes),
                     "--small-bytes", str(args.small_bytes),
                     "--subset", str(args.subset),
                     "--window-file", window_file)
               for i in range(args.rr_workers)]
    puller = spawn("rr-kvpuller", "--port", str(hub_port),
                   "--seconds", str(args.seconds),
                   "--nodes", str(args.nodes),
                   "--blocks", str(args.blocks))

    # Steady-state ramp, then the drain + handoff cycle on node 0.
    time.sleep(min(2.0, args.seconds / 4))
    t_drain0 = time.time()
    succ = spawn("rr-succ", "--index", "0", "--port", str(hub_port),
                 "--handoff", handoff, "--blocks", str(args.blocks),
                 "--block-bytes", str(args.block_bytes))
    nodes[0].stdin.write(f"drain {handoff}\n")
    nodes[0].stdin.flush()
    drain_report = json.loads(nodes[0].stdout.readline())
    succ_report = json.loads(succ.stdout.readline())
    t_drain1 = time.time()
    with open(window_file, "w") as f:
        json.dump({"start": t_drain0, "end": t_drain1}, f)

    worker_reports = [json.loads(w.stdout.readline()) for w in workers]
    puller_report = json.loads(puller.stdout.readline())
    for w in workers:
        w.wait(timeout=60)
    puller.wait(timeout=60)
    for p, msg in [(nodes[0], "quit"), (succ, "quit"), (hub, "quit")] + \
            [(n, "quit") for n in nodes[1:]]:
        try:
            p.stdin.write(msg + "\n")
            p.stdin.flush()
        except (BrokenPipeError, ValueError):
            pass
    for p in nodes + [succ, hub]:
        p.wait(timeout=60)
    try:
        os.unlink(window_file)
    except OSError:
        pass

    errors = sum(r["errors"] for r in worker_reports)
    calls = sum(r["calls"] for r in worker_reports)
    steady = [r["steady_p99_us"] for r in worker_reports
              if r["steady_p99_us"] > 0]
    drain = [r["drain_p99_us"] for r in worker_reports
             if r["drain_samples"] > 0]
    drain_samples_total = sum(r["drain_samples"] for r in worker_reports)
    steady_p99 = max(steady) if steady else 0
    drain_p99 = max(drain) if drain else 0
    ratio = round(drain_p99 / steady_p99, 3) if steady_p99 and drain_p99 \
        else 0.0
    summary = {
        "mode": "rolling_restart",
        "nodes": args.nodes,
        "workers": args.rr_workers,
        "seconds": args.seconds,
        "subset": args.subset,
        "calls": calls,
        "errors": errors,
        "steady_p99_us": steady_p99,
        "drain_p99_us": drain_p99,
        "drain_p99_ratio": ratio,
        "drain_samples_total": drain_samples_total,
        "drain_window_s": round(t_drain1 - t_drain0, 3),
        "drained_clean": drain_report.get("drained", False),
        "adopted_port": succ_report.get("adopted_port"),
        "takeover_generation": succ_report.get("generation"),
        "prefix_takeover_generation": succ_report.get("prefix_generation"),
        "same_port": succ_report.get("adopted_port") == node_ports[0],
        "kv": puller_report,
        "elapsed_s": round(time.monotonic() - t_start, 1),
    }
    print(json.dumps(summary, indent=None if args.json else 2), flush=True)
    # The p99 criterion must be MEASURED, not vacuously true: at least
    # one call has to land inside the drain window.  The prefix lane's
    # replica-set path must re-home across the drain with ZERO stale
    # admits and no generation regressions in the match view.
    ok = (errors == 0 and calls > 0 and
          summary["drained_clean"] and summary["same_port"] and
          puller_report["stale_admits"] == 0 and
          puller_report["mismatches"] == 0 and
          puller_report["fetches"] > 0 and
          puller_report["prefix_stale_admits"] == 0 and
          puller_report["prefix_gen_regressions"] == 0 and
          puller_report["prefix_fetches"] > 0 and
          puller_report["prefix_takeover_gen"] >= 2 and
          drain_samples_total > 0 and steady_p99 > 0 and
          ratio > 0 and ratio <= 2.0)
    return 0 if ok else 1


# ---- orchestrator --------------------------------------------------------

def run_orchestrator(args) -> int:
    want_fds = args.conns + 1024
    achieved = raise_fd_limit(want_fds)
    fd_limited = achieved < want_fds
    if fd_limited:
        # Documented per-box maximum (e.g. a sandboxed kernel refusing
        # setrlimit past the hard cap even for root): the server needs
        # one fd per conn plus ~1k headroom (listeners, library
        # internals, worker pipes); workers have their own budgets.
        args.conns = max(1024, achieved - 1024)
    per_worker = (args.conns + args.workers - 1) // args.workers

    env = _env()

    t0 = time.monotonic()
    server = subprocess.Popen(
        [sys.executable, "-m", MODULE, "--role", "server",
         "--conns", str(args.conns), "--shards", str(args.shards),
         "--dispatchers", str(args.dispatchers),
         "--qos", args.qos, "--qos-lanes", str(args.qos_lanes)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env, text=True)
    port_line = server.stdout.readline()
    try:
        port = json.loads(port_line)["port"]
    except (json.JSONDecodeError, KeyError):
        print(f"server failed to start: {port_line!r}", file=sys.stderr)
        server.kill()
        return 1

    workers = []
    for i in range(args.workers):
        workers.append(subprocess.Popen(
            [sys.executable, "-m", MODULE, "--role", "worker",
             "--index", str(i), "--host", "127.0.0.1",
             "--port", str(port), "--conns", str(per_worker),
             "--big-every", str(args.big_every),
             "--big-bytes", str(args.big_bytes),
             "--small-bytes", str(args.small_bytes),
             "--timeout", str(args.timeout),
             "--ramp-batch", str(args.ramp_batch),
             "--tenant", args.tenant, "--priority", str(args.priority),
             "--shape", args.shape,
             "--hold", str(args.hold)],
            stdout=subprocess.PIPE, env=env, text=True))

    reports = []
    for w in workers:
        line = w.stdout.readline()
        try:
            reports.append(json.loads(line))
        except json.JSONDecodeError:
            reports.append({"attempted": per_worker, "connected": 0,
                            "echoed": 0, "wedged": per_worker,
                            "failures": {"worker_crash": 1}})

    # Peak stats while every worker still HOLDS its connections.
    server.stdin.write("stats\n")
    server.stdin.flush()
    peak = json.loads(server.stdout.readline())
    for w in workers:
        w.wait(timeout=args.hold + 60)
    server.stdin.write("quit\n")
    server.stdin.flush()
    json.loads(server.stdout.readline())  # final stats (post-drain)
    server.wait(timeout=60)

    summary = {
        "target_conns": args.conns,
        "fd_limit": achieved,
        "fd_limited": fd_limited,
        "workers": args.workers,
        "attempted": sum(r.get("attempted", 0) for r in reports),
        "connected": sum(r.get("connected", 0) for r in reports),
        "echoed": sum(r.get("echoed", 0) for r in reports),
        "wedged": sum(r.get("wedged", 0) for r in reports),
        "connect_failures": sum(
            r.get("failures", {}).get("connect", 0) for r in reports),
        "server_peak": peak,
        "elapsed_s": round(time.monotonic() - t0, 1),
        "big_every": args.big_every,
        "big_bytes": args.big_bytes,
        "shards": args.shards,
        "dispatchers": args.dispatchers,
    }
    if args.shape:
        mix: dict[str, int] = {}
        for r in reports:
            for t, n in r.get("shape_mix", {}).items():
                mix[t] = mix.get(t, 0) + n
        summary["shape"] = args.shape
        summary["shape_mix"] = mix
    print(json.dumps(summary, indent=None if args.json else 2), flush=True)
    ok = (summary["wedged"] == 0 and
          summary["echoed"] == summary["connected"] and
          summary["connected"] >= args.conns * 99 // 100)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--role",
                    choices=["orchestrator", "server", "worker", "rr-hub",
                             "rr-node", "rr-succ", "rr-worker",
                             "rr-kvpuller", "infer-server", "infer-hold",
                             "infer-serve", "infer-flood"],
                    default="orchestrator")
    ap.add_argument("--infer", action="store_true",
                    help="the streamed-inference cycle: ramp 100k logical "
                         "token streams over a handful of connections "
                         "(fd proof), drain every one to EOS, measure "
                         "TTFT/TPOT through the prefix cache, then shed "
                         "a 2x-overloaded hog tenant typed-only")
    ap.add_argument("--infer-streams", type=int, default=100_000,
                    help="concurrent logical token streams to hold")
    ap.add_argument("--channels", type=int, default=2,
                    help="connections per hold worker (streams "
                         "multiplex; the whole point is channels << "
                         "streams)")
    ap.add_argument("--streams", type=int, default=0,
                    help="(infer-hold role) completions this worker "
                         "submits and holds")
    ap.add_argument("--serve-workers", type=int, default=4)
    ap.add_argument("--flood-workers", type=int, default=2)
    ap.add_argument("--hold-streams", type=int, default=16,
                    help="(infer-flood role) concurrent completions the "
                         "hog tries to keep in flight")
    ap.add_argument("--max-new", type=int, default=16,
                    help="decode tokens per serving-phase completion")
    ap.add_argument("--prompt-tokens", type=int, default=32)
    ap.add_argument("--pool", type=int, default=8,
                    help="hot prompts shared across serve workers (the "
                         "prefix cache converges on these)")
    ap.add_argument("--step-us", type=int, default=1000,
                    help="serving-phase decode tick (trpc_infer_step_us)")
    ap.add_argument("--overload-step-us", type=int, default=5000,
                    help="overload-phase decode tick (coarser: the "
                         "loaded/unloaded TPOT ratio must measure "
                         "admission isolation, not scheduler oversleep "
                         "on a saturated box)")
    ap.add_argument("--prefill-us", type=int, default=5,
                    help="serving-phase trpc_infer_prefill_us_per_token")
    ap.add_argument("--fd-cap", type=int, default=20_000,
                    help="the box's fd ceiling the stream proof must "
                         "stay under")
    ap.add_argument("--flags", default="",
                    help="(infer-server role) comma-joined k=v flags set "
                         "before the server starts")
    ap.add_argument("--rolling-restart", action="store_true",
                    help="the rolling-restart cycle: drain + hot-restart "
                         "one node of a 3-node naming-backed cluster "
                         "under mixed 1KB + striped load and KV pulls; "
                         "reports errors (must be 0), steady vs drain-"
                         "window p99, and stale KV admits (must be 0)")
    ap.add_argument("--seconds", type=float, default=10.0,
                    help="rolling-restart load duration per worker")
    ap.add_argument("--nodes", type=int, default=3)
    ap.add_argument("--rr-workers", type=int, default=2)
    ap.add_argument("--blocks", type=int, default=2,
                    help="KV blocks published per node")
    ap.add_argument("--block-bytes", type=int, default=256 << 10)
    ap.add_argument("--subset", type=int, default=2,
                    help="trpc_cluster_subset_size per worker (0 = off)")
    ap.add_argument("--window-file", default="")
    ap.add_argument("--handoff", default="")
    ap.add_argument("--conns", type=int, default=100_000)
    ap.add_argument("--workers", type=int, default=12)
    ap.add_argument("--big-every", type=int, default=1000,
                    help="every Nth connection moves --big-bytes instead "
                         "of 1KB (0 disables)")
    ap.add_argument("--big-bytes", type=int, default=4 << 20)
    ap.add_argument("--small-bytes", type=int, default=1024)
    ap.add_argument("--shards", type=int, default=8,
                    help="SO_REUSEPORT acceptor shards")
    ap.add_argument("--dispatchers", type=int, default=4,
                    help="epoll event loops (trpc_event_dispatchers)")
    ap.add_argument("--qos", default="",
                    help="server qos spec (Server.set_qos grammar)")
    ap.add_argument("--qos-lanes", type=int, default=0)
    ap.add_argument("--tenant", default="")
    ap.add_argument("--priority", type=int, default=0)
    ap.add_argument("--shape", default="",
                    help="trpc capture file: sample each connection's "
                         "(request size, tenant, priority) from the "
                         "recorded empirical distribution instead of the "
                         "fixed small/big split")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="worker ramp+verify budget (s)")
    ap.add_argument("--ramp-batch", type=int, default=256,
                    help="connections opened per select tick per worker")
    ap.add_argument("--hold", type=float, default=10.0,
                    help="seconds workers hold connections after their "
                         "report; must exceed worker finish SKEW, since "
                         "the peak-stats sample happens after the LAST "
                         "report while the first worker is already "
                         "holding")
    ap.add_argument("--smoke", action="store_true",
                    help="bounded smoke: ~2k conns, short timeout")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--index", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args(argv)
    if args.smoke and args.infer:
        args.infer_streams = min(args.infer_streams, 4000)
        args.workers = min(args.workers, 4)
        args.seconds = min(args.seconds, 4.0)
        args.serve_workers = min(args.serve_workers, 2)
    elif args.smoke:
        args.conns = min(args.conns, 2000)
        args.workers = min(args.workers, 4)
        args.timeout = min(args.timeout, 60.0)
        args.big_every = 500
        # Generous vs worker finish skew on loaded CI boxes: an early
        # worker must still be holding when the last one reports and the
        # peak snapshot is taken (the smoke test asserts live_sockets
        # covers every connection).
        args.hold = 15.0
    if args.role == "server":
        run_server(args)
        return 0
    if args.role == "worker":
        run_worker(args)
        return 0
    if args.role == "rr-hub":
        run_rr_hub(args)
        return 0
    if args.role == "rr-node":
        run_rr_node(args)
        return 0
    if args.role == "rr-succ":
        run_rr_succ(args)
        return 0
    if args.role == "rr-worker":
        run_rr_worker(args)
        return 0
    if args.role == "rr-kvpuller":
        run_rr_kvpuller(args)
        return 0
    if args.role == "infer-server":
        run_infer_server(args)
        return 0
    if args.role == "infer-hold":
        run_infer_hold(args)
        return 0
    if args.role == "infer-serve":
        run_infer_serve(args)
        return 0
    if args.role == "infer-flood":
        run_infer_flood(args)
        return 0
    if args.infer:
        return run_infer_orchestrator(args)
    if args.rolling_restart:
        return run_rolling_restart(args)
    return run_orchestrator(args)


if __name__ == "__main__":
    sys.exit(main())
