"""Card roofline constants — port of brpc_tpu/ops/roofline.py for NVIDIA H100.

Published device-memory bandwidth per card, and NVLink bandwidth per
direction between the cards of one host, keyed by
`torch.cuda.get_device_name()`.  A kernel's time is reported beside its
bound (bytes it must move over these rates) so a shortfall is visible.

Source: NVIDIA H100 Tensor Core GPU data sheet (SXM5 80GB HBM3, PCIe 80GB,
NVL 94GB); NVLink: 900 GB/s per SXM5 card, 450 GB/s each way.
"""

from __future__ import annotations

HBM_PEAK_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,  # SXM5
    "NVIDIA H100 PCIe": 2000.0,
    "NVIDIA H100 NVL": 3900.0,
}

#: NVLink per direction, per card (the SXM5 part's 900 GB/s total).
NVLINK_PEAK_GBPS = {
    "NVIDIA H100 80GB HBM3": 450.0,  # SXM5
}


def _lookup(table: dict, device_name: str) -> float | None:
    if device_name in table:
        return table[device_name]
    for k, v in table.items():
        if device_name.startswith(k):
            return v
    return None


def hbm_peak_gbps(device_name: str) -> float | None:
    """Peak device-memory bandwidth in GB/s for a CUDA device name, or None
    if unknown."""
    return _lookup(HBM_PEAK_GBPS, device_name)


def nvlink_peak_gbps(device_name: str) -> float | None:
    """Peak NVLink bandwidth per direction in GB/s for a CUDA device name,
    or None if unknown."""
    return _lookup(NVLINK_PEAK_GBPS, device_name)


def gather_bound_ms(n: int, chunk_bytes: int, hbm_gbps: float) -> float:
    """K2's bound with every peer on one card: device-memory bytes, read n
    chunks and write n outputs of n chunks, (n + n^2) * C, over the HBM
    rate.  n = 8, C = 8 MiB at 3350 GB/s: 603,979,776 B, 0.1803 ms."""
    return (n + n * n) * chunk_bytes / (hbm_gbps * 1e9) * 1e3


def gather_cross_card_bound_ms(n: int, chunk_bytes: int, hbm_gbps: float,
                               nvlink_gbps: float) -> float:
    """K2's bound with one peer on each of n cards, per card (every card
    does the same work at once): the larger of (a) its HBM bytes, read its
    chunk C and write its output n * C, over the HBM rate, and (b) its
    NVLink egress, its chunk to the n - 1 other cards, (n - 1) * C, over
    NVLink's rate per direction.  n = 4, C = 8 MiB: (b) 25,165,824 B at
    450 GB/s, 0.0559 ms; n = 8: 58,720,256 B, 0.1305 ms (below the
    one-card bound, the bytes spreading over eight HBMs)."""
    hbm = (1 + n) * chunk_bytes / (hbm_gbps * 1e9) * 1e3
    link = (n - 1) * chunk_bytes / (nvlink_gbps * 1e9) * 1e3
    return max(hbm, link)
