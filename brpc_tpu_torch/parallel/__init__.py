from brpc_tpu_torch.parallel.fabric import P, Fabric, NamedSharding  # noqa: F401
