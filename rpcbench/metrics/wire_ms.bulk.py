"""wire_ms.bulk: the mean milliseconds from the native runtime's issue of a
batch call to its completion stamp, before the response's landing copy
(the recorder rpc_client_batch, read by name; rpcbench/batch_queue.py)."""

from rpcbench import batch_queue


def read(run):
    us = batch_queue.wire_us(run)
    return None if us is None else us / 1e3
