"""The port's dryrun (`graft_entry.dryrun_multichip`) over n logical CPU
peers, for the reference's matrix n in {1, 2, 3, 4, 6, 8}; every leg checks
its own result and raises on a wrong one.  The reference's dryrun runs on
the conftest's CPU mesh beside it at the same n."""

import pytest
import torch

import __graft_entry__
from brpc_tpu_torch.graft_entry import dryrun_multichip


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_dryrun_multichip(n):
    dryrun_multichip(n, device="cpu")
    __graft_entry__.dryrun_multichip(n)


def test_dryrun_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2)
