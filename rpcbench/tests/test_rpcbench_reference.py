"""The plain reference against answers worked by hand."""

import numpy as np
import pytest
import torch

from rpcbench import reference


@pytest.mark.parametrize("lanes, want", [
    ([1, 2, 3], 6),
    ([0xFFFFFFFF, 2], 1),
    ([0x80000000, 0x80000000], 0),
    ([0xFFFFFFFF] * 4, 0xFFFFFFFC),
    ([], 0),
])
def test_wrapping_sum_by_hand(lanes, want):
    assert reference.wrapping_sum(np.array(lanes, dtype=np.uint32)) == want


def test_wrapping_sum_refuses_other_lanes():
    with pytest.raises(TypeError):
        reference.wrapping_sum(np.array([1, 2], dtype=np.int64))


def test_u32_lanes_reads_the_bits():
    t = torch.tensor([-1, 5], dtype=torch.int32).view(torch.uint32)
    assert reference.u32_lanes(t).tolist() == [0xFFFFFFFF, 5]


def test_same_bytes_compares_bits():
    a = torch.tensor([0.0, float("nan")])
    assert reference.same_bytes(a, a.clone())
    assert not reference.same_bytes(torch.tensor([0.0, 1.0]),
                                    torch.tensor([-0.0, 1.0]))
    assert not reference.same_bytes(torch.zeros(4), torch.zeros(5))


def test_gathered_stacks_in_peer_order():
    chunks = [torch.full((2, 3), float(r)) for r in range(4)]
    out = reference.gathered(chunks, torch.device("cpu"))
    assert out.shape == (8, 3)
    assert out[:, 0].tolist() == [0, 0, 1, 1, 2, 2, 3, 3]


def test_lossy_steps_differ_where_lanes_are_wide():
    lanes = torch.tensor([1 << 24, (1 << 24) + 1, 0xFFFFFFFF, 7],
                         dtype=torch.int64).to(torch.int32).view(
        torch.uint32)
    echoed = reference.u32_lanes(reference.lossy_echo(lanes)).tolist()
    assert echoed[0] == 1 << 24 and echoed[3] == 7
    assert echoed[1] != (1 << 24) + 1  # float32 drops the low bit
    exact = reference.wrapping_sum(reference.u32_lanes(lanes))
    assert reference.lossy_sum(lanes) != exact
    chunks = [torch.tensor([[1.0 + 2 ** -10]])] * 2
    assert not reference.same_bytes(
        reference.lossy_gathered(chunks, torch.device("cpu")),
        reference.gathered(chunks, torch.device("cpu")))
