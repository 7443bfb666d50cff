"""The control: the reference put in the program's place one step down in
precision, which every cell's check has to reject.

The echo deployment states exact delivery and an exact 32-bit wrapping
checksum; the control echoes the lanes through float32 and sums them in
float32.  The gather deployment states a bit-exact gather of float32
chunks; the control gathers them through bfloat16.  Both run on the card
at the cell's own sizes (`python3 rpcbench/calibrate.py --system
control`), and at a small size in the tests.
"""

from __future__ import annotations

from rpcbench import reference


def _u32(value: int, device):
    """A 0-dim uint32 tensor holding value (0 <= value < 2^32)."""
    import torch

    v = torch.tensor(value, dtype=torch.int64, device=device)
    return (v - ((v >> 31) << 32)).to(torch.int32).view(torch.uint32)


class LossyEchoPipeline:
    """`EchoPipeline`'s interface, with no RPC: each call's echo is the
    payload through float32, and its checksum the float32 sum."""

    def __init__(self, channel, payload, resp_bufs, method="Echo.Echo",
                 timeout_ms=0, rows=16, cols=8192):
        self.payload = payload
        self.copy = reference.lossy_echo(payload)
        self.sent = _u32(reference.lossy_sum(payload), payload.device)
        self._pending = 0

    @property
    def inflight(self) -> int:
        return self._pending

    def submit(self, k: int) -> None:
        self._pending += k

    def poll(self, max_n: int = 64, timeout_ms: int = -1):
        out = []
        for _ in range(min(max_n, self._pending)):
            back = reference.lossy_echo(self.payload)
            out.append((back, _u32(reference.lossy_sum(back), back.device)))
        self._pending -= len(out)
        return out

    def close(self) -> None:
        self._pending = 0


def lossy_gather(chunks: list, streams=None) -> list:
    """`ring_all_gather`'s interface: every peer's output gathered
    through bfloat16."""
    return [reference.lossy_gathered(chunks, c.device) for c in chunks]


SYSTEMS = {"echo_closed_loop": LossyEchoPipeline,
           "gather_closed_loop": lossy_gather}
