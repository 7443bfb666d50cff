from brpc_tpu_torch.streaming.stream import ring_stream, stream_echo  # noqa: F401
