"""ring_wait_us.calls: the mean microseconds a batch call is held by the
host after its completion stamp: the landing copy, the completion ring and
the poll's return (rpc_client_batch_held_us over rpc_client_batch_drained
less the recorder's mean; rpcbench/batch_queue.py)."""

from rpcbench import batch_queue

COUNTERS = batch_queue.HELD


def read(run):
    return batch_queue.ring_wait_us(run)
