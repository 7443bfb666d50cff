"""rpcbench: the benchmark of brpc_tpu_torch, the PyTorch and CUDA port.

One command runs one cell of `BENCHMARK.json` once:

    python3 rpcbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or metric sits in
a file of its own, found by the name `BENCHMARK.json` gives it:

- `configs/<config>.json`: a deployment (`file` in `BENCHMARK.json`);
- `traffic/<traffic>.json`: a traffic mix, naming its generator;
- `generators/<generator>.py`: a general generator that reads such mixes;
- `metrics/<metric>.py`: the reader of one metric, end-to-end or per layer.

The yardstick (peaks and byte counts, `yardstick.py`), the plain reference
(`reference.py`) and the control that must fail it (`control.py`) live here
too, where the program cannot move them.  Nothing here imports jax, jaxlib,
flax or the JAX package; the program is imported only by the generators.
"""
