"""The qos_1k_under_16m cell on the CPU: a sound run is `correct`, and each
planted fault fails its check (replies crossed between the classes, the
latency class tagged to the bulk class's lane, the bulk class stalled for a
whole progress interval, and the control).  The run skips the look for a
card and drives both classes on the CPU at a small size."""

import time

import pytest
import torch

from brpc_tpu_torch.models.echo import EchoPipeline
from brpc_tpu_torch.ops.echo_kernel import echo_fused
from rpcbench import control, harness

CELL = "qos_1k_under_16m"
PROGRESS = 0.25
MIX = {"latency": {"payload_bytes": 1024, "inflight": 16,
                   "calls_per_payload": 24, "check_sum_every": 1,
                   "check_bytes_every": 2, "warm_windows": 2},
       "bulk": {"payload_bytes": 64 * 1024, "rate_hz": 100, "inflight": 4,
                "calls_per_payload": 8, "check_sum_every": 1,
                "check_bytes_every": 2, "keep_bytes_max": 4,
                "warm_windows": 2},
       "progress_s": PROGRESS}
BULK_LANES = MIX["bulk"]["payload_bytes"] // 4


def _run(root, system=None, seconds=1.2):
    return harness.run_cell(root, CELL, 2 ** 31 + 19, seconds, False,
                            t_start=time.perf_counter(), device="cpu",
                            system=system, overrides=MIX,
                            log=lambda line: None)


def crossed_replies():
    """Each class's echoes carry the bytes of the other class's latest
    payload, cut or repeated to its own size, checksummed as they are."""
    latest = {}

    class Crossed(EchoPipeline):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            latest[self.copy.numel()] = self.copy

        def poll(self, *a, **k):
            out = super().poll(*a, **k)
            n = self.copy.numel()
            other = [c for m, c in latest.items() if m != n]
            if not out or not other:
                return out
            src = other[0].view(torch.int32).reshape(-1)
            back = src.repeat(-(-n // src.numel()))[:n].clone().view(
                torch.uint32)
            got = echo_fused(back, 1, n)[1]
            return [(back, got) for _ in out]

    return Crossed


def lane_three():
    """Every pipeline tags its channel for lane 3, keeping its tenant: the
    latency class's calls are served from the bulk class's lane."""

    class LaneThree(EchoPipeline):
        def __init__(self, channel, *a, **k):
            channel.set_qos(channel.qos[0], 3)
            super().__init__(channel, *a, **k)

    return LaneThree


def bulk_stalled():
    """The bulk class's polls stop for three progress intervals once its
    first poll is a progress interval old; every call still comes back."""
    first = []

    class Stalled(EchoPipeline):
        def poll(self, *a, **k):
            if self.copy.numel() == BULK_LANES:
                now = time.perf_counter()
                if not first:
                    first.append(now)
                elif len(first) == 1 and now - first[0] > PROGRESS:
                    first.append(now)
                    time.sleep(3 * PROGRESS)
            return super().poll(*a, **k)

    return Stalled


def test_a_sound_run_is_correct(root):
    result = _run(root)
    assert result["correct"] is True and result["failed"] == 0
    checks = result["checks"]
    assert checks["lane_calls_off"]["compared"] == result["attempted"]
    assert checks["starved_intervals"]["compared"] == 2 * int(1.2 // PROGRESS)
    for cls in ("latency", "bulk"):
        assert checks[f"bad_checksums.{cls}"]["compared"] > 0
        assert checks[f"bad_echoes.{cls}"]["compared"] > 0


@pytest.mark.parametrize("fault, caught_by", [
    (crossed_replies, ("bad_checksums.latency", "bad_checksums.bulk",
                       "bad_echoes.latency", "bad_echoes.bulk")),
    (lane_three, ("lane_calls_off", "unserved_calls.latency")),
    (bulk_stalled, ("starved_intervals",)),
    (lambda: control.LossyEchoPipeline, ("bad_checksums.latency",
                                         "bad_checksums.bulk")),
], ids=["replies-crossed", "latency-on-lane-3", "bulk-stalled", "control"])
def test_faults_are_caught(root, fault, caught_by):
    result = _run(root, system=fault(), seconds=1.6)
    assert result["correct"] is False
    for name in caught_by:
        assert result["checks"][name]["value"] > 0, name
