"""The yardstick: published peaks and the bytes each kernel must move.

A frozen copy of `brpc_tpu_torch/ops/roofline.py`, kept here so that no
change to the program can move the bounds its kernels are held to.

Peaks: NVIDIA H100 Tensor Core GPU data sheet (SXM5 80GB HBM3, PCIe 80GB,
NVL 94GB); NVLink: 900 GB/s per SXM5 card, 450 GB/s each way.  The rates
assume the card's full power limit (700 W for the SXM5 part).
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
    """Published device-memory bandwidth in GB/s, or None if unknown."""
    return _lookup(HBM_PEAK_GBPS, device_name)


def nvlink_peak_gbps(device_name: str) -> float | None:
    """Published NVLink bandwidth per direction in GB/s, or None."""
    return _lookup(NVLINK_PEAK_GBPS, device_name)


def k1_bytes(payload_bytes: int) -> int:
    """K1 (the fused echo copy and checksum) reads the payload once and
    writes its copy once."""
    return 2 * payload_bytes


def k1_bound_ms(payload_bytes: int, hbm_gbps: float) -> float:
    """K1's least time: its bytes at the HBM rate.  64 MiB at 3350 GB/s:
    134,217,728 B, 0.04006 ms."""
    return k1_bytes(payload_bytes) / (hbm_gbps * 1e9) * 1e3


def k2_bound_ms(n: int, chunk_bytes: int, hbm_gbps: float,
                nvlink_gbps: float) -> tuple[float, str]:
    """K2's least time per card with one peer on each of n cards (every
    card does the same work at once), and what bounds it: the larger of
    its HBM bytes, reading its chunk C and writing its output n * C,
    (1 + n) * C over the HBM rate, and its NVLink egress, its chunk to the
    n - 1 other cards, (n - 1) * C over NVLink's rate per direction.
    n = 4, C = 64 MiB: NVLink, 201,326,592 B at 450 GB/s, 0.4474 ms."""
    hbm = (1 + n) * chunk_bytes / (hbm_gbps * 1e9) * 1e3
    link = (n - 1) * chunk_bytes / (nvlink_gbps * 1e9) * 1e3
    return (link, "nvlink") if link >= hbm else (hbm, "hbm")
