"""Port parity: brpc_tpu_torch.tools.kv_disagg against tools/kv_disagg.py,
at a cut size (2 blocks of 1 MiB, 1 s windows, every role on the CPU).

- Both drivers run the whole workload; the port's row carries every key
  of the reference's, and both are verified, prefix phase included.
- The port's decode role pulls from the reference's prefill role and the
  other way round: the landed bytes equal each block's pattern.
- The port's pattern function equals the reference's numpy pattern.
"""

import json
import os
import pathlib
import select
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from brpc_tpu_torch.tools import kv_disagg

REPO = pathlib.Path(__file__).resolve().parent.parent
REF_TOOL = str(REPO / "tools" / "kv_disagg.py")
PORT = ["-m", "brpc_tpu_torch.tools.kv_disagg"]
SMALL = ["--blocks", "2", "--block-mb", "1"]
TIMEOUT_S = 120


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _popen(args):
    return subprocess.Popen([sys.executable, *args], cwd=REPO, env=_env(),
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _line(proc, prefix: str) -> str:
    """The rest of the first stdout line of proc starting with prefix."""
    deadline = time.time() + TIMEOUT_S
    while time.time() < deadline:
        ready, _, _ = select.select([proc.stdout], [], [], 1.0)
        if not ready:
            continue
        line = proc.stdout.readline()
        if not line:
            break
        if line.startswith(prefix):
            return line[len(prefix):].strip()
    proc.kill()
    raise AssertionError(f"no {prefix!r} line: "
                         + proc.communicate(timeout=10)[1][-2000:])


def _stop(proc) -> None:
    try:
        proc.stdin.close()
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def _driver_row(proc) -> dict:
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def test_driver_rows_carry_the_reference_keys_and_verify():
    args = ["--json", *SMALL, "--seconds", "1"]
    ref = _popen([REF_TOOL, *args])   # both at once: one wall clock
    port = _popen([*PORT, *args, "--device", "cpu"])
    want, got = _driver_row(ref), _driver_row(port)
    missing = set(want) - set(got)
    assert not missing, f"port row lacks reference keys {sorted(missing)}"
    assert set(got) - set(want) == {"device", "device_goodput_gbps",
                                    "device_verified", "k1_launches"}
    for row in (want, got):
        assert row["verified"] is True and row["prefix_fetch_verified"] is True
        assert row["kv_failures"] == 0 and row["kv_fetches"] > 0
    assert got["device_verified"] is True and got["device"] == "cpu"
    assert got["k1_launches"] == 0  # CPU tensors take the plain version
    assert got["device_goodput_gbps"] > 0
    for key in ("blocks", "block_bytes", "depth", "qos_spec",
                "prefix_blocks_total", "prefix_block_bytes"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("prefill,decode", [("reference", "port"),
                                            ("port", "reference")])
def test_decode_pulls_across_packages(prefill, decode):
    """One package's decode role pulls the other's prefill role's blocks:
    block 0 equals its pattern (`verified`), and for the port's decode
    every landed block's checksum equals its pattern's."""
    tool = {"reference": [REF_TOOL], "port": PORT}
    dev = {"reference": [], "port": ["--device", "cpu"]}
    pre = _popen([*tool[prefill], "--role", "prefill", *SMALL,
                  *dev[prefill]])
    dec = None
    try:
        port = _line(pre, "PORT ")
        dec = _popen([*tool[decode], "--role", "decode", *SMALL,
                      "--prefill", f"127.0.0.1:{port}", "--seconds", "0.5",
                      "--depth", "2", *dev[decode]])
        _line(dec, "PORT ")
        row = json.loads(_line(dec, "ROW "))
    finally:
        for p in (dec, pre):
            if p is not None:
                _stop(p)
    assert row["verified"] is True
    assert row["kv_failures"] == 0 and row["kv_fetches"] > 0
    assert row["kv_bytes"] == row["kv_fetches"] * (1 << 20)
    if decode == "port":
        assert row["device_verified"] is True


@pytest.mark.parametrize("block", [0, 11])
def test_block_pattern_equals_the_reference_numpy_pattern(block):
    nbytes = 8 << 20
    want = ((np.arange(nbytes, dtype=np.uint64) * 2654435761
             + block * 97) >> 13).astype(np.uint8)
    got = kv_disagg.block_pattern(block, nbytes, "cpu")
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("argv", [["--json"], ["--role", "prefill"],
                                  ["--role", "decode", "--prefill", "x:1"]])
def test_every_role_raises_without_a_card_or_device_cpu(argv):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kv_disagg.main(argv)
