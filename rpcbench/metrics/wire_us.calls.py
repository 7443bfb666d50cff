"""wire_us.calls: the mean microseconds from the native runtime's issue of
a batch call to its completion stamp, before the response's landing copy
(the recorder rpc_client_batch, read by name; rpcbench/batch_queue.py)."""

from rpcbench import batch_queue


def read(run):
    return batch_queue.wire_us(run)
