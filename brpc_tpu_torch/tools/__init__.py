"""Ports of the repository's tools/ scripts that drive brpc_tpu.rpc, as
modules of the package (`python -m brpc_tpu_torch.tools.<name>`)."""
