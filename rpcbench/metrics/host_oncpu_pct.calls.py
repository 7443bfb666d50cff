"""host_oncpu_pct.calls: the CPU time of the thread that drives the
EchoPipelines over its wall time, read at a flush of a pipeline's clocks at
most every half second, over the window, in percent (gauges trpc_echo_host_cpu_ns /
trpc_echo_host_cpu_wall_ns, read by name; rpcbench/main_thread.py).  A
program without those gauges reads nothing."""

from rpcbench import main_thread

COUNTERS = (main_thread.HOST_CPU_NS, main_thread.HOST_CPU_WALL_NS)


def read(run):
    return main_thread.host_oncpu_pct(run)
