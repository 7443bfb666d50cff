"""Runs one cell of BENCHMARK.json once, on the card, and prints its result.

    python3 rpcbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The last line of standard output is one
JSON object (`correct`, `attempted`, `failed`, `metrics`, `device`, with
`--trace 1` also `breakdown`, and last `checks`: each number compared with
its limit); the last lines of standard error give the same checks.  With
`--trace 0` the metrics are the cell's end-to-end metrics, with `--trace 1`
its per-layer metrics, read from a profiled slice of the window.

Exits non-zero, printing no result, when there is no CUDA card or fewer
cards than the cell asks for, when the program is not in the checkout, or
when jax, jaxlib, flax or the JAX package was loaded.  Build and kernel
caches stay in `build/` inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _cache_dirs() -> None:
    """Every compiler cache the run could use, at fixed paths inside the
    checkout (the program's own builds already go to build/)."""
    cache = ROOT / "build" / "rpcbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")


def _fail(code: int, message: str) -> int:
    print(f"rpcbench: {message}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    # Run as a file, the script's own folder heads sys.path: put the
    # checkout's root there instead, so rpcbench is imported as a package.
    here = str(pathlib.Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p and
                   str(pathlib.Path(p).resolve()) != here]
    sys.path.insert(0, str(ROOT))
    if not (ROOT / "brpc_tpu_torch" / "__init__.py").is_file():
        return _fail(2, f"the program (brpc_tpu_torch) is not in {ROOT}")

    import torch

    from rpcbench import harness, spec

    try:
        cell = spec.Spec.load(ROOT).cell(args.workload)
    except spec.SpecError as e:
        return _fail(2, str(e))
    if not torch.cuda.is_available():
        return _fail(2, "no CUDA card: torch.cuda.is_available() is False")
    if torch.cuda.device_count() < cell["chips"]:
        return _fail(2, f"{args.workload} needs {cell['chips']} cards, "
                     f"{torch.cuda.device_count()} visible")
    try:
        result = harness.run_cell(ROOT, args.workload, args.seed,
                                  args.seconds, bool(args.trace),
                                  t_start=T_START)
    except harness.RunError as e:
        return _fail(3, str(e))
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
