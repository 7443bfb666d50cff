"""On the card: the program's host spans under a profiler that traces the
card, read as rpcbench/program_spans.py reads them.  Skips without a CUDA
card."""

import json

import pytest

from rpcbench import program_spans

pytestmark = pytest.mark.card

K2 = ("trpc.k2.alloc", "trpc.k2.plan", "trpc.k2.order", "trpc.k2.launch")


def _profiled(fn, path):
    import torch
    import torch.profiler as tp

    acts = [tp.ProfilerActivity.CPU, tp.ProfilerActivity.CUDA]
    with tp.profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return out, program_spans.program_spans(events)


def test_k2_spans_nest_inside_the_gather(card, tmp_path):
    import torch

    from brpc_tpu_torch.ops.ring_kernel import ring_all_gather

    chunks = [torch.full((4096,), float(i), device=card) for i in range(2)]
    ring_all_gather(chunks)  # builds and warms K2
    torch.cuda.synchronize()
    outs, spans = _profiled(lambda: ring_all_gather(chunks),
                            tmp_path / "k2.json")
    assert all(torch.equal(o, torch.cat(chunks)) for o in outs)
    (gather,) = [s for s in spans if s[0] == "trpc.k2.gather"]
    inner = [s for s in spans if s[0] != "trpc.k2.gather"]
    assert {s[0] for s in inner} == set(K2)
    assert all(s[1] == gather[1] and gather[2] <= s[2] and s[3] <= gather[3]
               for s in inner)


def test_k2_spans_on_the_fenced_path(card, tmp_path):
    """Two fenced launches on two streams of one card: the path every
    gather across cards takes, with its second order span (the turns,
    under the fenced lock)."""
    import torch

    from brpc_tpu_torch.ops.ring_kernel import ring_all_gather_fenced

    streams = [torch.cuda.Stream(card) for _ in range(2)]
    chunks = [torch.full((4096,), float(i), device=card) for i in range(2)]
    torch.cuda.synchronize()
    ring_all_gather_fenced(chunks, streams)  # makes the barrier flags
    torch.cuda.synchronize()
    outs, spans = _profiled(lambda: ring_all_gather_fenced(chunks, streams),
                            tmp_path / "fenced.json")
    assert all(torch.equal(o, torch.cat(chunks)) for o in outs)
    names = [s[0] for s in spans]
    assert set(names) == set(K2)
    assert names.count("trpc.k2.order") == 2


def test_echo_spans_on_the_card(card, tmp_path):
    import torch

    from brpc_tpu_torch.models.echo import EchoPipeline
    from brpc_tpu_torch.rpc import Channel, Server

    srv = Server()
    srv.register_native_echo("Echo.Echo")
    srv.start(0)
    ch = Channel(f"127.0.0.1:{srv.port}", timeout_ms=10000)
    payload = torch.arange(256, dtype=torch.int32, device=card).view(
        torch.uint32)
    bufs = [torch.empty(1024, dtype=torch.uint8, pin_memory=True)
            for _ in range(4)]
    pipe = EchoPipeline(ch, payload, bufs, rows=1, cols=256)

    def loop():
        done = []
        pipe.submit(4)
        while len(done) < 8:
            got = pipe.poll(max_n=4, timeout_ms=10000)
            assert got, "wedged"
            done += got
            if len(done) <= 4:
                pipe.submit(len(got))  # takes buffers with an H2D behind
        return done

    try:
        done, spans = _profiled(loop, tmp_path / "echo.json")
    finally:
        pipe.close()
        ch.close()
        srv.stop()
        srv.close()
    assert all(int(g) == int(pipe.sent) for _, g in done)
    names = [s[0] for s in spans]
    assert {"trpc.echo.submit", "trpc.echo.reuse_wait", "trpc.batch.stage",
            "trpc.batch.issue", "trpc.echo.poll", "trpc.batch.wait",
            "trpc.echo.land", "trpc.echo.check"} == set(names)
    assert names.count("trpc.echo.land") == names.count(
        "trpc.echo.check") == 8
