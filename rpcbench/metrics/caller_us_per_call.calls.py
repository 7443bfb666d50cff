"""caller_us_per_call.calls: microseconds of the window a completed call
outside EchoPipeline.poll, its native wait and EchoPipeline.submit: the
caller's own loop (the window less the gauges trpc_echo_poll_ns,
trpc_echo_poll_wait_ns and trpc_echo_submit_ns, read by name;
rpcbench/main_thread.py).  A program without those gauges reads nothing."""

from rpcbench import main_thread

COUNTERS = (main_thread.POLL_NS, main_thread.POLL_WAIT_NS,
            main_thread.SUBMIT_NS)


def read(run):
    return main_thread.caller_us(run)
