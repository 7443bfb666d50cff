"""poll_us_per_call.calls: wall microseconds inside EchoPipeline.poll, less
its native wait, a landed call over the window (gauges trpc_echo_poll_ns /
trpc_echo_landed, read by name; rpcbench/main_thread.py).  A program
without those gauges reads nothing."""

from rpcbench import main_thread

COUNTERS = (main_thread.POLL_NS, main_thread.LANDED)


def read(run):
    return main_thread.poll_us(run)
