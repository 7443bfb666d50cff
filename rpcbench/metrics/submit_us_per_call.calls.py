"""submit_us_per_call.calls: wall microseconds inside EchoPipeline.submit a
submitted call over the window (gauges trpc_echo_submit_ns /
trpc_echo_submitted, read by name; rpcbench/main_thread.py).  A program
without those gauges reads nothing."""

from rpcbench import main_thread

COUNTERS = (main_thread.SUBMIT_NS, main_thread.SUBMITTED)


def read(run):
    return main_thread.submit_us(run)
