"""device_wait_us.qos: host microseconds the latency class's EchoPipelines
spent blocked on device work a call landed, over the window: the tenant
gauges trpc_echo_fg_device_wait_us (the reuse_wait event synchronises and
the staging synchronise of each submit) over trpc_echo_fg_landed, read by
name.  A program without those gauges reads nothing."""

COUNTERS = ("trpc_echo_fg_device_wait_us", "trpc_echo_fg_landed")


def read(run):
    waited = run.counter_delta("trpc_echo_fg_device_wait_us")
    landed = run.counter_delta("trpc_echo_fg_landed")
    if not landed or waited is None:
        return None
    return waited / landed
