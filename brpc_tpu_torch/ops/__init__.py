from brpc_tpu_torch.ops.checksum import fletcher32, sum32  # noqa: F401
