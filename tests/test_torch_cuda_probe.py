"""brpc_tpu_torch.tools.cuda_probe (port of tools/pjrt_probe.py) on the CPU
control: A, C and E succeed with the bytes matching, as the reference's
control does, and the report goes where it is told — never over the
committed CUDA_PROBE.md."""

import importlib.util
import json
import pathlib

import pytest
import torch

from brpc_tpu_torch.tools import cuda_probe

REPO = pathlib.Path(__file__).resolve().parent.parent
COMMITTED = REPO / "brpc_tpu_torch" / "tools" / "CUDA_PROBE.md"


@pytest.fixture(scope="module")
def control(tmp_path_factory):
    out = tmp_path_factory.mktemp("probe") / "probe.md"
    before = COMMITTED.read_bytes() if COMMITTED.exists() else None
    assert cuda_probe.main(["--cpu", "--out", str(out)]) == 0
    after = COMMITTED.read_bytes() if COMMITTED.exists() else None
    assert before == after, "the probe wrote over the committed report"
    text = out.read_text()
    body = text[text.index("```json") + 7:text.rindex("```")]
    return json.loads(body)


def test_report_holds_only_the_control(control):
    assert set(control) == {"cpu_control"}
    assert control["cpu_control"]["backend"]["device"] == "cpu"
    assert set(control["cpu_control"]["attempts"]) == set(cuda_probe.ATTEMPTS)


@pytest.mark.parametrize("attempt", ["A_data_ptr", "C_host_staging",
                                     "E_pointer_identity"])
def test_control_attempts_succeed(control, attempt):
    got = control["cpu_control"]["attempts"][attempt]
    assert got["ok"] is True, got
    if attempt == "A_data_ptr":
        assert got["host_readable"] is True
    if attempt == "C_host_staging":
        assert got["bytes_match"] is True
    if attempt == "E_pointer_identity":
        for name in ("A_data_ptr", "D_register_our_slab"):
            e = got[name]
            assert e["host_readable"] and e["identity"] and e["bytes_match"]
            assert e["block_ptr"] == e["ptr"]


def test_control_dlpack_and_slab(control):
    att = control["cpu_control"]["attempts"]
    assert att["B_dlpack"]["ok"] and att["B_dlpack"]["same_ptr"]
    assert att["B_dlpack"]["dl_device"] == [1, 0]  # kDLCPU
    d = att["D_register_our_slab"]
    assert d["ok"] and d["bytes_match"] and d["registered"] is False


def test_reference_control_agrees_on_a_c_e(control):
    """The reference's CPU control (jax) succeeds at the same attempts."""
    spec = importlib.util.spec_from_file_location(
        "ref_pjrt_probe", REPO / "tools" / "pjrt_probe.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    got, _ = ref.run_child(cpu=True)
    att = got["attempts"]
    assert att["A_unsafe_buffer_pointer"]["ok"]
    assert att["C_host_staging"]["ok"]
    assert att["E_pointer_identity"]["bytes_match"] is True
    port = control["cpu_control"]["attempts"]
    assert port["A_data_ptr"]["ok"] and port["C_host_staging"]["ok"]
    assert port["E_pointer_identity"]["A_data_ptr"]["bytes_match"] is True


def test_an_attempt_that_overruns_is_killed():
    got = cuda_probe.run_attempt("A_data_ptr", "cpu", timeout=0.01)
    assert got == {"ok": False, "error": "timeout after 0.01s"}


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_probe_raises_without_a_card_or_cpu(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda_probe.main(["--out", str(tmp_path / "x.md")])
    assert not (tmp_path / "x.md").exists()
