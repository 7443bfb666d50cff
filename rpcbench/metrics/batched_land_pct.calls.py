"""batched_land_pct.calls: the share of the calls EchoPipeline landed that
its batched in-place launch landed, over the window (counters
trpc_echo_landed_batched / trpc_echo_landed, read by name), in percent.
A program without those counters reads nothing."""

COUNTERS = ("trpc_echo_landed", "trpc_echo_landed_batched")


def read(run):
    landed = run.counter_delta("trpc_echo_landed")
    batched = run.counter_delta("trpc_echo_landed_batched")
    if not landed or batched is None:
        return None
    return 100.0 * batched / landed
