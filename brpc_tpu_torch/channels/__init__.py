from brpc_tpu_torch.channels.combo import (  # noqa: F401
    DynamicPartitionChannel,
    ParallelChannel,
    PartitionChannel,
    SelectiveChannel,
)
from brpc_tpu_torch.channels.balancer import (  # noqa: F401
    ConsistentHash,
    EwmaP2C,
    RandomBalancer,
    RoundRobin,
    WeightedRandom,
)
