from brpc_tpu_torch.rpc._lib import IOBuf, load_library  # noqa: F401
from brpc_tpu_torch.rpc.client import Channel, RpcError  # noqa: F401
from brpc_tpu_torch.rpc.server import Call, Server  # noqa: F401
