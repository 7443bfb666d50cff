"""copied_submit_pct.calls: the share of the calls EchoPipelines submitted
whose request the native runtime copied inside the submit's crossing (no
pin, no deleter), over the window (counters trpc_echo_submitted_copied /
trpc_echo_submitted, read by name), in percent.  A program without those
counters reads nothing."""

COUNTERS = ("trpc_echo_submitted", "trpc_echo_submitted_copied")


def read(run):
    submitted = run.counter_delta("trpc_echo_submitted")
    copied = run.counter_delta("trpc_echo_submitted_copied")
    if not submitted or copied is None:
        return None
    return 100.0 * copied / submitted
