"""Port of brpc_tpu/rpc: the ctypes surface of the shared native runtime.
The reference's capture, collective, kv and naming modules are not ported
yet."""

from brpc_tpu_torch.rpc import fault  # noqa: F401
from brpc_tpu_torch.rpc import infer  # noqa: F401
from brpc_tpu_torch.rpc import observe  # noqa: F401
from brpc_tpu_torch.rpc import rma  # noqa: F401
from brpc_tpu_torch.rpc import stream  # noqa: F401
from brpc_tpu_torch.rpc import tuner  # noqa: F401
from brpc_tpu_torch.rpc._lib import (  # noqa: F401
    IOBuf,
    load_library,
    parse_endpoint,
)
from brpc_tpu_torch.rpc.batch import (  # noqa: F401
    Batch,
    Completion,
    ZeroCopyResponse,
)
from brpc_tpu_torch.rpc.client import (  # noqa: F401
    Channel,
    ClusterChannel,
    DeadlineExpiredError,
    DrainingError,
    OverloadedError,
    RpcError,
    deadline_scope,
)
from brpc_tpu_torch.rpc.flags import get_flag, set_flag  # noqa: F401
from brpc_tpu_torch.rpc.infer import InferClient  # noqa: F401
from brpc_tpu_torch.rpc.rma import RmaBuffer, kernel_supports  # noqa: F401
from brpc_tpu_torch.rpc.server import Call, Server  # noqa: F401
from brpc_tpu_torch.rpc.stream import (  # noqa: F401
    Stream,
    StreamChunkTooLargeError,
    StreamClosedError,
    StreamTimeoutError,
    open_stream,
)
