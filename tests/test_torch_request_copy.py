"""The request-mode timing tool (`tools/request_copy.py`) on the CPU, at a
toy size: both modes echo every call and report positive rates.  Its
numbers mean something on the card's host only."""

import json
import time

from brpc_tpu_torch.rpc import zerocopy
from brpc_tpu_torch.rpc.batch import COPY_REQUEST_MAX
from brpc_tpu_torch.tools import request_copy


def test_both_modes_run_and_report(capsys):
    assert request_copy.main(["--sizes", "64,4096", "--calls", "64",
                              "--depth", "8", "--rounds", "1"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["copy_request_max"] == COPY_REQUEST_MAX
    assert [r["bytes"] for r in got["sizes"]] == [64, 4096]
    for row in got["sizes"]:
        for mode in request_copy.MODES:
            assert row[f"{mode}_calls_per_s"] > 0
            assert row[f"{mode}_submit_us_per_call"] > 0
    deadline = time.monotonic() + 10  # the reference mode's pins drain
    while zerocopy.live_sends() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert zerocopy.live_sends() == 0


def test_the_constant_stays_within_64_kib():
    assert 0 < COPY_REQUEST_MAX <= 64 << 10
