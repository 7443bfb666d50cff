"""calls_per_poll.calls: calls EchoPipeline landed over the polls that
landed them, over the window (gauges trpc_echo_landed / trpc_echo_polls,
read by name; rpcbench/main_thread.py).  A program without those gauges
reads nothing."""

from rpcbench import main_thread

COUNTERS = (main_thread.LANDED, main_thread.POLLS)


def read(run):
    return main_thread.calls_per_poll(run)
