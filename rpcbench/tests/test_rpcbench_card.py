"""On the card: each one-card cell at its own sizes passes its check in a
short window, and its control fails it.  Skips without a CUDA card."""

import time

import pytest

from rpcbench import control, harness

pytestmark = pytest.mark.card


@pytest.mark.parametrize("cell", ["echo_64m_d8", "echo_1k_d64"])
def test_cell_and_its_control_on_the_card(root, card, cell):
    def run(system):
        return harness.run_cell(root, cell, 2 ** 31 + 21, 1.0, False,
                                t_start=time.perf_counter(), system=system,
                                log=lambda line: None)

    sound = run(None)
    assert sound["correct"] and sound["failed"] == 0
    assert sound["device"]["platform"] == "gpu"
    assert run(control.LossyEchoPipeline)["correct"] is False
