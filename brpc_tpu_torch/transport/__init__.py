from brpc_tpu_torch.transport.ici import IciTransport  # noqa: F401
