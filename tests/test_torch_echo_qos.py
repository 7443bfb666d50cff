"""A QoS class carried from the channel down to the echo pipeline, on the
CPU: the channels' read-only `qos` tag, two tagged `EchoPipeline`s driven
from two threads against one native echo server with the priority lanes on
(each echo and checksum against rpcbench's plain reference, each class's
calls dispatched from its own lane, nothing shed, the per-tenant gauges),
and an untagged pipeline that leaves the tenant gauges alone.  The class
streams themselves run on the card only
(tests/card/test_torch_echo_qos_card.py)."""

import threading

import numpy as np
import pytest
import torch

import brpc_tpu_torch.rpc as port
from brpc_tpu_torch import payload_from_numpy
from brpc_tpu_torch.models.echo import (LANDED, TENANT_DEVICE_WAIT_US,
                                        TENANT_LANDED, EchoPipeline)
from brpc_tpu_torch.rpc import get_flag, observe, set_flag
from rpcbench import reference

FLAGS = {"trpc_qos_lanes": "4", "trpc_qos_lane_weights": "8,4,2,1"}
#: (tenant, priority, payload lanes, landing buffers, calls)
CLASSES = (("qosfg", 0, 256, 16, 96), ("qosbulk", 3, 16384, 4, 24))


def _var(name: str) -> int:
    try:
        return int(observe.Vars.read(name))
    except KeyError:
        return 0


@pytest.fixture
def lanes():
    """The priority lanes on, and the flags as they were after the test."""
    saved = {k: get_flag(k) for k in FLAGS}
    for k, v in FLAGS.items():
        set_flag(k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            set_flag(k, v)
    assert {k: get_flag(k) for k in FLAGS} == saved


@pytest.fixture
def server(lanes):
    srv = port.Server()
    srv.register_native_echo("Echo.Echo")
    srv.set_qos("qosfg:weight=8;qosbulk:weight=1")
    srv.start(0)
    yield srv
    srv.stop()
    srv.close()


def test_channel_remembers_its_tag(server):
    addr = f"127.0.0.1:{server.port}"
    ch = port.Channel(addr, timeout_ms=5000)
    tagged = port.Channel(addr, timeout_ms=5000, qos_tenant="alice",
                          qos_priority=2)
    try:
        assert ch.qos is None
        assert tagged.qos == ("alice", 2)
        ch.set_qos("bob", 1)
        assert ch.qos == ("bob", 1)
        tagged.set_qos("", 0)  # the default tag is no tag
        assert tagged.qos is None
        with pytest.raises(AttributeError):
            ch.qos = ("eve", 0)
        assert ch.call("Echo.Echo", b"tagged") == b"tagged"
    finally:
        ch.close()
        tagged.close()


def test_cluster_channel_remembers_its_tag(server):
    url = f"list://127.0.0.1:{server.port}"
    cc = port.ClusterChannel(url, "rr", timeout_ms=5000)
    tagged = port.ClusterChannel(url, "rr", timeout_ms=5000,
                                 qos_tenant="carol", qos_priority=0)
    try:
        assert cc.qos is None
        assert tagged.qos == ("carol", 0)
        tagged.set_qos("carol", 3)
        assert tagged.qos == ("carol", 3)
        cc.set_qos("dave", 0)
        assert cc.qos == ("dave", 0)
        cc.set_qos("", 0)  # the default tag is no tag
        assert cc.qos is None
    finally:
        cc.close()
        tagged.close()


def _drive(pipe, calls: int, depth: int, out: list) -> None:
    """A refill loop of `calls` completions at `depth` in flight."""
    pipe.submit(depth)
    submitted = depth
    while len(out) < calls:
        got = pipe.poll(max_n=depth, timeout_ms=10000)
        if not got:
            raise RuntimeError("wedged")
        out += got
        k = min(len(got), calls - submitted)
        if k:
            pipe.submit(k)
            submitted += k


def test_two_tagged_classes_from_two_threads(server):
    addr = f"127.0.0.1:{server.port}"
    rng = np.random.default_rng(19)
    runs = []
    for tenant, prio, lanes, depth, calls in CLASSES:
        arr = rng.integers(0, 1 << 32, size=lanes, dtype=np.uint32)
        ch = port.Channel(addr, timeout_ms=10000, qos_tenant=tenant,
                          qos_priority=prio,
                          connection_type="pooled" if prio else "single")
        bufs = [torch.empty(lanes * 4, dtype=torch.uint8)
                for _ in range(depth)]
        pipe = EchoPipeline(ch, payload_from_numpy(arr, "cpu"), bufs,
                            rows=1, cols=lanes)
        assert pipe.qos == (tenant, prio)
        runs.append((arr, ch, pipe, depth, calls, []))
    names = ([f"qos_lane_dispatch_{i}" for i in range(4)]
             + ["qos_shed_total", LANDED]
             + [TENANT_LANDED.format(t) for t, *_ in CLASSES]
             + [TENANT_DEVICE_WAIT_US.format(t) for t, *_ in CLASSES])
    before = {n: _var(n) for n in names}
    errors = []

    def work(pipe, depth, calls, out):
        try:
            _drive(pipe, calls, depth, out)
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(p, d, c, o))
               for _, _, p, d, c, o in runs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    try:
        assert not any(t.is_alive() for t in threads)
        assert errors == []
    finally:
        for _, ch, pipe, *_ in runs:
            pipe.close()
            ch.close()
    moved = {n: _var(n) - v for n, v in before.items()}
    (fg_calls, bulk_calls) = (c for *_, c, _ in runs)
    assert moved["qos_lane_dispatch_0"] == fg_calls
    assert moved["qos_lane_dispatch_3"] == bulk_calls
    assert moved["qos_lane_dispatch_1"] == moved["qos_lane_dispatch_2"] == 0
    assert moved["qos_shed_total"] == 0
    assert moved[LANDED] == fg_calls + bulk_calls
    for (tenant, *_), (*_, calls, _) in zip(CLASSES, runs):
        assert moved[TENANT_LANDED.format(tenant)] == calls
        assert moved[TENANT_DEVICE_WAIT_US.format(tenant)] == 0  # no card
    for arr, _, pipe, _, calls, out in runs:
        assert len(out) == calls
        want = reference.wrapping_sum(arr)
        assert reference.wrapping_sum(reference.u32_lanes(pipe.sent)) == want
        payload = torch.from_numpy(arr.view(np.int32)).view(torch.uint32)
        for back, got in out:
            assert reference.same_bytes(back, payload)
            assert reference.wrapping_sum(reference.u32_lanes(got)) == want


def test_an_untagged_pipeline_leaves_the_tenant_gauges(server):
    arr = np.arange(256, dtype=np.uint32)
    ch = port.Channel(f"127.0.0.1:{server.port}", timeout_ms=10000)
    bufs = [torch.empty(1024, dtype=torch.uint8) for _ in range(8)]
    pipe = EchoPipeline(ch, payload_from_numpy(arr, "cpu"), bufs, rows=1,
                        cols=256)
    names = [LANDED] + [TENANT_LANDED.format(t) for t, *_ in CLASSES]
    before = {n: _var(n) for n in names}
    out = []
    try:
        assert pipe.qos is None
        _drive(pipe, 16, 8, out)
    finally:
        pipe.close()
        ch.close()
    moved = {n: _var(n) - v for n, v in before.items()}
    assert moved.pop(LANDED) == 16
    assert set(moved.values()) == {0}
    assert all(reference.same_bytes(b, torch.from_numpy(arr.view(np.int32)))
               for b, _ in out)


@pytest.mark.parametrize("threshold, lane_calls", [("2097152", 0),
                                                   ("0", 3)])
def test_a_striped_request_takes_no_lane(lanes, threshold, lane_calls):
    """Why the qos_lanes_echo deployment stripes nothing: a request
    striped over pooled rails is dispatched by the native reassembly
    layer, around the priority lanes; sent whole, it takes its lane."""
    saved = get_flag("trpc_stripe_threshold")
    set_flag("trpc_stripe_threshold", threshold)
    srv = port.Server()
    srv.register_native_echo("Echo.Echo")
    srv.start(0)
    ch = port.Channel(f"127.0.0.1:{srv.port}", timeout_ms=10000,
                      connection_type="pooled", qos_tenant="stripe",
                      qos_priority=3)
    before = _var("qos_lane_dispatch_3")
    req = bytes(range(256)) * (16 << 10)  # 4 MiB
    try:
        for _ in range(3):
            assert ch.call("Echo.Echo", req) == req
    finally:
        ch.close()
        srv.stop()
        srv.close()
        set_flag("trpc_stripe_threshold", saved)
    assert _var("qos_lane_dispatch_3") - before == lane_calls
