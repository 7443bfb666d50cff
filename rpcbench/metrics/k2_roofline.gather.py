"""k2_roofline.gather: K2's bound per card (rpcbench/yardstick.py: the
larger of (n - 1) x C at the published NVLink rate and (1 + n) x C at the
HBM rate) over the slowest card's mean K2 kernel time in the profiled
slice, in percent.  K2 is ops/ring_kernel.py -> csrc/ring_kernel.cu
(`bulk_gather`, `ragged_gather`)."""

from rpcbench import yardstick


def read(run):
    t = run.trace
    hbm = yardstick.hbm_peak_gbps(run.card)
    link = yardstick.nvlink_peak_gbps(run.card)
    if t is None or not hbm or not link:
        return None
    per_card = {}
    for o in t.ops_named("bulk_gather<", "ragged_gather<"):
        per_card.setdefault(o.device, []).append(o.seconds)
    if len(per_card) != len(t.devices):
        return None
    slowest_ms = max(sum(v) / len(v) for v in per_card.values()) * 1e3
    bound_ms, _ = yardstick.k2_bound_ms(len(t.devices),
                                        int(run.mix["chunk_bytes"]), hbm,
                                        link)
    return 100.0 * bound_ms / slowest_ms
