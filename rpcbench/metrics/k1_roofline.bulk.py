"""k1_roofline.bulk: K1's bound (2 x payload bytes at the card's published
HBM rate, rpcbench/yardstick.py) over K1's mean time on the card in the
profiled slice, in percent.  K1 is ops/echo_kernel.py ->
csrc/echo_kernel.cu (`echo_kernel`, `echo_ragged_kernel`)."""

from rpcbench import yardstick


def read(run):
    t = run.trace
    peak = yardstick.hbm_peak_gbps(run.card)
    if t is None or not peak:
        return None
    ops = t.ops_named("echo_kernel<", "echo_ragged_kernel<")
    if not ops:
        return None
    mean_ms = sum(o.seconds for o in ops) / len(ops) * 1e3
    return 100.0 * yardstick.k1_bound_ms(run.window.bytes_per_call,
                                         peak) / mean_ms
