"""`correct` comes out false when the timed path is broken underneath, once
for each fault a cell can have, and for the control (the reference one step
down in precision in the program's place).  Each run skips the look for a
card and drives the rest of a run on the CPU at a small size."""

import time

import pytest
import torch

from brpc_tpu_torch.models.echo import EchoPipeline
from brpc_tpu_torch.ops.echo_kernel import echo_fused
from rpcbench import control, harness

ECHO = {"payload_bytes": 1024, "inflight": 16, "calls_per_payload": 24,
        "check_sum_every": 1, "check_bytes_every": 2}
GATHER = {"chunk_bytes": 4096, "cols": 16, "check_every": 2}


def _run(root, cell, overrides, system=None):
    return harness.run_cell(root, cell, 2 ** 31 + 5, 0.4, False,
                            t_start=time.perf_counter(), device="cpu",
                            system=system, overrides=overrides,
                            log=lambda line: None)


class AlteredAnswer(EchoPipeline):
    """Every third echo has a lane flipped where it is produced; K1 then
    checksums the altered bytes."""

    seen = 0

    def poll(self, *a, **k):
        out = []
        for back, csum in super().poll(*a, **k):
            AlteredAnswer.seen += 1
            if AlteredAnswer.seen % 3 == 0:
                back = back.clone()
                back.view(torch.int32)[5] ^= 1
                _, csum = echo_fused(back, 1, back.numel())
            out.append((back, csum))
        return out


class HalfLeftOut(EchoPipeline):
    """Half of the completions are dropped: those calls never come back."""

    def poll(self, *a, **k):
        return super().poll(*a, **k)[::2]


class NeverLanded(EchoPipeline):
    """Each echo is read from a buffer its response never landed in."""

    def poll(self, *a, **k):
        out = []
        for back, _ in super().poll(*a, **k):
            stale = torch.full_like(back.view(torch.int32),
                                    int.from_bytes(b"\xa5" * 4, "little",
                                                   signed=True))
            stale = stale.view(torch.uint32)
            out.append((stale, echo_fused(stale, 1, stale.numel())[1]))
        return out


class StaleLanding(EchoPipeline):
    """Each set of landing buffers keeps the first responses that landed
    in it: every later echo read from it is an earlier turn's, correct for
    the payload that turn sent."""

    def __init__(self, channel, payload, resp_bufs, **kw):
        super().__init__(channel, payload, resp_bufs, **kw)
        self._set = resp_bufs[0]

    def poll(self, *a, **k):
        out = []
        for back, csum in super().poll(*a, **k):
            kept = getattr(self._set, "stale", None)
            if kept is None:
                kept = self._set.stale = (back.clone(), csum)
            out.append(kept)
        return out


class ReplyCache(EchoPipeline):
    """Answers every call from the copy it holds, never crossing the
    wire: the bytes are right, the server never saw the calls."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self._cached = 0

    @property
    def inflight(self) -> int:
        return self._cached

    def submit(self, k: int) -> None:
        self._cached += k

    def poll(self, max_n=64, timeout_ms=-1):
        n = min(max_n, self._cached)
        self._cached -= n
        return [(self.copy.clone(), self.sent.clone()) for _ in range(n)]


def _exchange_left_out(chunks, streams=None):
    outs = []
    for r, c in enumerate(chunks):
        out = torch.zeros((len(chunks) * c.shape[0], *c.shape[1:]),
                          dtype=c.dtype)
        out[r * c.shape[0]:(r + 1) * c.shape[0]] = c
        outs.append(out)
    return outs


class _Unchanged:
    """Hands back the first gather's outputs at every later step."""

    def __init__(self):
        self.first = None

    def __call__(self, chunks, streams=None):
        from brpc_tpu_torch.ops.ring_kernel import ring_all_gather

        if self.first is None:
            self.first = ring_all_gather(chunks)
        return self.first


def _altered_gather(chunks, streams=None):
    from brpc_tpu_torch.ops.ring_kernel import ring_all_gather

    outs = ring_all_gather(chunks)
    outs[-1].view(-1)[3] += 1.0
    return outs


def _half_the_peers(chunks, streams=None):
    from brpc_tpu_torch.ops.ring_kernel import ring_all_gather

    return ring_all_gather(chunks)[: len(chunks) // 2]


def test_sound_runs_are_correct(root):
    assert _run(root, "echo_1k_d64", ECHO)["correct"]
    assert _run(root, "echo_64m_d8", dict(ECHO, payload_bytes=1 << 19,
                                          inflight=4))["correct"]
    assert _run(root, "gather_4x64m", GATHER)["correct"]


@pytest.mark.parametrize("fault, caught_by", [
    (AlteredAnswer, "bad_checksums"),
    (HalfLeftOut, "missing_calls"),
    (NeverLanded, "bad_echoes"),
    (StaleLanding, "bad_checksums"),
    (ReplyCache, "unserved_calls"),
    (control.LossyEchoPipeline, "bad_checksums"),
], ids=["answer-altered", "half-left-out", "state-unchanged", "stale-landing",
        "reply-cache", "control"])
@pytest.mark.parametrize("cell", ["echo_1k_d64", "echo_64m_d8"])
def test_echo_faults_are_caught(root, cell, fault, caught_by):
    over = ECHO if cell == "echo_1k_d64" else dict(
        ECHO, payload_bytes=1 << 19, inflight=4)
    result = _run(root, cell, over, system=fault)
    assert result["correct"] is False
    assert result["checks"][caught_by]["value"] > 0
    assert result["failed"] > 0 or caught_by == "bad_echoes"


@pytest.mark.parametrize("fault", [
    _exchange_left_out, _Unchanged(), _altered_gather, _half_the_peers,
    control.lossy_gather,
], ids=["exchange-left-out", "state-unchanged", "answer-altered",
        "half-left-out", "control"])
def test_gather_faults_are_caught(root, fault):
    result = _run(root, "gather_4x64m", GATHER, system=fault)
    assert result["correct"] is False
    assert result["checks"]["bad_outputs"]["value"] > 0
    assert result["failed"] > 0
