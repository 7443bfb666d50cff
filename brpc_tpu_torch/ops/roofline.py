"""Card roofline constants — port of brpc_tpu/ops/roofline.py for NVIDIA H100.

Published device-memory bandwidth per card, keyed by
`torch.cuda.get_device_name()`.  A kernel's time is reported beside its
bound (bytes it must move over this rate) so a shortfall is visible.

Source: NVIDIA H100 Tensor Core GPU data sheet (SXM5 80GB HBM3, PCIe 80GB,
NVL 94GB).
"""

from __future__ import annotations

HBM_PEAK_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,  # SXM5
    "NVIDIA H100 PCIe": 2000.0,
    "NVIDIA H100 NVL": 3900.0,
}


def hbm_peak_gbps(device_name: str) -> float | None:
    """Peak device-memory bandwidth in GB/s for a CUDA device name, or None
    if unknown."""
    if device_name in HBM_PEAK_GBPS:
        return HBM_PEAK_GBPS[device_name]
    for k, v in HBM_PEAK_GBPS.items():
        if device_name.startswith(k):
            return v
    return None
