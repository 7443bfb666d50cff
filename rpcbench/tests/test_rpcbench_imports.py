"""No run loads jax, jaxlib, flax or the JAX package (by whole top-level
name), and the reference loads nothing of the program."""

import json
import subprocess
import sys

PROBE = """
import json, sys, time
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _modules(root, body):
    proc = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(root), body=body)],
        capture_output=True, text=True, timeout=300, cwd=root)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_a_rehearsal_loads_no_jax(root):
    body = """
from rpcbench import harness
for cell, over in (("echo_1k_d64", {}),
                   ("gather_4x64m", {"chunk_bytes": 4096, "cols": 16})):
    harness.run_cell(".", cell, 3, 0.3, True, t_start=time.perf_counter(),
                     device="cpu", overrides=dict(over, trace_slice_s=0.1),
                     log=lambda line: None)
"""
    loaded = _modules(root, body)
    assert "brpc_tpu_torch" in loaded  # the program ran
    assert not loaded & {"jax", "jaxlib", "flax", "brpc_tpu"}


def test_the_reference_loads_nothing_of_the_program(root):
    loaded = _modules(root, "import rpcbench.reference, rpcbench.yardstick")
    assert not loaded & {"brpc_tpu_torch", "brpc_tpu", "jax", "jaxlib"}


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from rpcbench import harness

    monkeypatch.setitem(sys.modules, "brpc_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert "brpc_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()
