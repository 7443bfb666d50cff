"""brpc_tpu_torch/tools/lint_trpc.py against tools/lint_trpc.py and against
faults planted in a copy of the repository.

The shared cpp/ rules must report what the reference reports on the same
mutated copy; each rule over the port's side must name itself and the
port's file when one of the port's bindings or tables drifts from cpp/ or
csrc/.  No GPU: the lint reads sources only.
"""

import contextlib
import pathlib
import shutil
import subprocess
import sys

import pytest

from brpc_tpu_torch.tools import lint_trpc

REPO = pathlib.Path(__file__).resolve().parent.parent
COPIED = ("cpp", "brpc_tpu", "brpc_tpu_torch", "tools", "tests", "bench.py",
          "chip_smoke.py")
SHARED_RULES = ("flag-validator", "var-help", "tail-group", "tuner-rule",
                "atomic-comment")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A copy of the files both linters read."""
    root = tmp_path_factory.mktemp("lint") / "repo"
    for name in COPIED:
        src = REPO / name
        if src.is_dir():
            shutil.copytree(src, root / name, ignore=shutil.ignore_patterns(
                "__pycache__", "*.pyc"))
        else:
            shutil.copy2(src, root / name)
    return root


@contextlib.contextmanager
def mutated(root, rel, old, new):
    """`root/rel` with the one occurrence of `old` replaced by `new`."""
    path = root / rel
    text = path.read_text()
    assert text.count(old) == 1, f"{rel} holds {text.count(old)} x {old!r}"
    path.write_text(text.replace(old, new))
    try:
        yield
    finally:
        path.write_text(text)


def both_linters(root) -> tuple:
    """(the reference's violations, the port's) on the tree at `root`; the
    reference runs as a script of that tree, beside the port's lint."""
    proc = subprocess.Popen(
        [sys.executable, str(root / "tools" / "lint_trpc.py")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = lint_trpc.lint(root)
    out, err = proc.communicate(timeout=60)
    ref = [ln.strip() for ln in out.splitlines() if ln.startswith("  ")]
    assert proc.returncode == (1 if ref else 0), out + err
    return ref, port


def of_rules(violations, rules) -> list:
    return sorted(v for v in violations
                  if any(f"[{r}]" in v for r in rules))


def test_lint_is_clean_on_the_repo():
    proc = subprocess.run(
        [sys.executable, "-m", "brpc_tpu_torch.tools.lint_trpc"], cwd=REPO,
        capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "lint_trpc: clean"


def test_main_lints_the_tree_it_is_given(tree, capsys):
    assert lint_trpc.main(tree) == 0
    assert capsys.readouterr().out.strip() == "lint_trpc: clean"
    with mutated(tree, "brpc_tpu_torch/ops/_kernels.py", "ctypes.CDLL(",
                 "ctypes.PyDLL("):
        assert lint_trpc.main(tree) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"lint_trpc: {len(out) - 1} violation(s)"
    assert all(ln.startswith("  brpc_tpu_torch/ops/_kernels.py:")
               for ln in out[1:])


# One planted fault per shared rule: (rule, file under cpp/, old, new).
SHARED_MUTATIONS = [
    ("flag-validator", "net/stripe.cc", "    f->set_int_range(lo, hi);\n",
     ""),
    ("var-help", "stat/default_variables.cc",
     'rss.expose("process_memory_rss_kb", "resident set size (VmRSS)");',
     'rss.expose("process_memory_rss_kb");'),
    ("tail-group", "net/protocol.cc", "// tail-group 2 (compress):",
     "// tail-group 7 (compress):"),
    ("tuner-rule", "stat/tuner.cc", 'r.knob = "trpc_stripe_rails";',
     'r.knob = "trpc_stripe_railz";'),
    ("atomic-comment", "net/socket.cc",
     "wr_ev_.value.store(0, std::memory_order_relaxed);   // pre-publication",
     "wr_ev_.value.store(0, std::memory_order_relaxed);"),
]


@pytest.mark.parametrize("rule,rel,old,new", SHARED_MUTATIONS,
                         ids=[m[0] for m in SHARED_MUTATIONS])
def test_shared_rules_report_what_the_reference_reports(tree, rule, rel, old,
                                                        new):
    with mutated(tree, f"cpp/{rel}", old, new):
        ref, port = (of_rules(v, SHARED_RULES) for v in both_linters(tree))
    assert any(f"[{rule}]" in v and v.startswith(f"cpp/{rel}:")
               for v in ref), ref
    assert port == ref


_LIB = "brpc_tpu_torch/rpc/_lib.py"
_OBSERVE = "brpc_tpu_torch/rpc/observe.py"
# A typo'd flag, spelled so that this file's own text holds no reference.
_TYPO_FLAG = 'set_flag("' + 'trpc_' + 'fleet_top_typo", "1")\n'
_MAIN = 'if __name__ == "__main__":\n'

# One planted fault per port-facing check: (id, rule, port file, old, new).
PORT_MUTATIONS = [
    ("signature_missing", "capi-gil", _LIB,
     '    "trpc_iobuf_size": ([_P], _SZ),\n', ""),
    ("argtype_dropped", "capi-gil", _LIB,
     '"trpc_iobuf_append": ([_P, _S, _SZ], None)',
     '"trpc_iobuf_append": ([_P, _S], None)'),
    ("size_return_as_int", "capi-gil", _LIB,
     '"trpc_iobuf_block_count": ([_P], _SZ)',
     '"trpc_iobuf_block_count": ([_P], _I)'),
    ("size_param_as_int", "capi-gil", _LIB,
     '"trpc_iobuf_pop_front": ([_P, _SZ], _SZ)',
     '"trpc_iobuf_pop_front": ([_P, ctypes.c_int], _SZ)'),
    ("ring_stream_dropped", "capi-gil", "brpc_tpu_torch/ops/ring_kernel.py",
     "ctypes.c_int,\n        ctypes.c_void_p]", "ctypes.c_int]"),
    ("lcg_size_as_int", "capi-gil", "brpc_tpu_torch/ops/lcg.py",
     "ctypes.c_size_t", "ctypes.c_int"),
    ("pydll", "capi-gil", "brpc_tpu_torch/ops/_kernels.py", "ctypes.CDLL(",
     "ctypes.PyDLL("),
    ("timeline_renumbered", "timeline-event", _OBSERVE,
     "# timeline-event 3 (fiber_run)", "# timeline-event 30 (fiber_run)"),
    ("digest_marker_dropped", "digest-wire", _OBSERVE,
     "  # digest-wire 2 (TRPCFL01)", ""),
    ("error_code_changed", "error-code-sync", _LIB, '"kEKvMiss": 2101',
     '"kEKvMiss": 2199'),
    ("flag_typo", "flag-exists", "brpc_tpu_torch/tools/fleet_top.py",
     _MAIN, _TYPO_FLAG + _MAIN),
]


@pytest.mark.parametrize("rule,rel,old,new", [m[1:] for m in PORT_MUTATIONS],
                         ids=[m[0] for m in PORT_MUTATIONS])
def test_port_rules_catch_a_drifted_binding(tree, rule, rel, old, new):
    with mutated(tree, rel, old, new):
        found = lint_trpc.lint(tree)
    assert found, "the planted fault went unreported"
    assert all(f"[{rule}]" in v for v in found), found
    assert any(v.startswith(f"{rel}:") for v in found), found


def test_ring_binding_reports_the_count_and_the_prototype(tree):
    with mutated(tree, "brpc_tpu_torch/ops/ring_kernel.py",
                 "ctypes.c_int,\n        ctypes.c_void_p]", "ctypes.c_int]"):
        found = lint_trpc.lint(tree)
    assert len(found) == 1, found
    assert ("brpc_ring_all_gather takes 10 argument(s) "
            "(brpc_tpu_torch/csrc/ring_kernel.cu:") in found[0]
    assert found[0].endswith("but argtypes lists 9")


@pytest.mark.parametrize("old,new,tail", [
    # a short binding: the timeout slot dropped
    ("ctypes.POINTER(ctypes.c_uint64),\n        ctypes.c_ulonglong]",
     "ctypes.POINTER(ctypes.c_uint64)]", "but argtypes lists 13"),
    # a narrow slot: the 64-bit timeout passed as a 32-bit int
    ("ctypes.c_ulonglong]", "ctypes.c_int]", "ctypes.c_int (int)"),
])
def test_fenced_ring_binding_is_held_to_its_prototype(tree, old, new, tail):
    """The fenced entry's binding (brpc_ring_all_gather_xcard) is read
    where `_kernels.load(...)` loads it, like brpc_ring_all_gather's."""
    with mutated(tree, "brpc_tpu_torch/ops/ring_kernel.py", old, new):
        found = lint_trpc.lint(tree)
    assert found, "the planted fault went unreported"
    assert all("brpc_ring_all_gather_xcard" in v
               and "brpc_tpu_torch/csrc/ring_kernel.cu:" in v
               for v in found), found
    assert any(tail in v for v in found), found


def test_kernel_entry_without_a_definition_is_reported(tree):
    with mutated(tree, "brpc_tpu_torch/ops/lcg.py",
                 "_kernels.load(KERNEL).brpc_lcg",
                 "_kernels.load(KERNEL).brpc_lcg2"):
        found = lint_trpc.lint(tree)
    assert len(found) == 1 and "brpc_lcg2 is loaded from csrc/lcg_kernel.cu" \
        in found[0], found


@pytest.mark.parametrize("source,name,count", [
    ("batch_capi.cc", "trpc_batch_submit", 11),
    ("base_capi.cc", "trpc_iobuf_append_user_data", 5),
    ("base_capi.cc", "trpc_iobuf_create", 0),
])
def test_prototype_parse_balances_parentheses(source, name, count):
    """The reference's `[^)]*` stops at a function pointer's first `)`
    (trpc_batch_submit read as 9 parameters); the port's parse counts a
    function-pointer parameter once."""
    protos = lint_trpc.c_prototypes(REPO / "cpp" / "capi" / source)
    assert len(protos[name].params) == count, protos[name]


@pytest.mark.parametrize("decl,kind", [
    ("void (*req_deleter)(void*, void*)", "ptr"),
    ("const void* const* reqs", "ptr"),
    ("HandlerCb cb", "ptr"),
    ("size_t n", "int64"),
    ("unsigned long long chunk_bytes", "int64"),
    ("long", "int64"),
    ("uint32_t base", "int"),
    ("int threads", "int"),
    ("void", "void"),
])
def test_c_slot_kinds(decl, kind):
    assert lint_trpc.c_kind(decl, {"HandlerCb"}) == kind
