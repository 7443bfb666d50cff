"""Host-side load balancers over peer indices.  The port's own copy of
brpc_tpu/channels/balancer.py (pure Python; importing the reference's copy
would import jax): the same picks for the same seeds.

Parity with the reference's LB family (SURVEY.md §2.4, policy/*_load_balancer):
round-robin, (weighted) random, consistent hashing, and an EWMA
latency-feedback balancer standing in for locality-aware + p2c.  The balanced
"servers" are mesh peer indices consumed by
:class:`brpc_tpu_torch.channels.combo.SelectiveChannel`; feedback comes from the
caller the way ``Controller::Call::OnComplete`` feeds brpc's LBs
(brpc's src/brpc/controller.cpp:804).
"""

from __future__ import annotations

import bisect
import hashlib
import itertools
import random
import threading

__all__ = ["RoundRobin", "RandomBalancer", "WeightedRandom", "ConsistentHash", "EwmaP2C"]


class RoundRobin:
    def __init__(self, n: int):
        self._it = itertools.cycle(range(n))
        self._lock = threading.Lock()

    def pick(self, key=None) -> int:
        with self._lock:
            return next(self._it)

    def feedback(self, peer: int, latency_s: float) -> None:
        pass


class RandomBalancer:
    def __init__(self, n: int, seed: int = 0):
        self.n = n
        self._rng = random.Random(seed)

    def pick(self, key=None) -> int:
        return self._rng.randrange(self.n)

    def feedback(self, peer: int, latency_s: float) -> None:
        pass


class WeightedRandom:
    def __init__(self, weights, seed: int = 0):
        self.weights = list(weights)
        self._rng = random.Random(seed)

    def pick(self, key=None) -> int:
        return self._rng.choices(range(len(self.weights)), self.weights)[0]

    def feedback(self, peer: int, latency_s: float) -> None:
        pass


class ConsistentHash:
    """Ketama-style ring: `replicas` virtual nodes per peer, md5 points."""

    def __init__(self, n: int, replicas: int = 50):
        points = []
        for peer in range(n):
            for r in range(replicas):
                h = hashlib.md5(f"{peer}:{r}".encode()).digest()
                points.append((int.from_bytes(h[:8], "little"), peer))
        points.sort()
        self._ring = [p[0] for p in points]
        self._peers = [p[1] for p in points]

    def pick(self, key) -> int:
        h = hashlib.md5(str(key).encode()).digest()
        x = int.from_bytes(h[:8], "little")
        i = bisect.bisect_left(self._ring, x) % len(self._ring)
        return self._peers[i]

    def feedback(self, peer: int, latency_s: float) -> None:
        pass


class EwmaP2C:
    """Power-of-two-choices with EWMA latency feedback (p2c_ewma parity)."""

    def __init__(self, n: int, alpha: float = 0.2, seed: int = 0):
        self.lat = [0.0] * n
        self.alpha = alpha
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def pick(self, key=None) -> int:
        a, b = self._rng.sample(range(len(self.lat)), 2) if len(self.lat) > 1 else (0, 0)
        return a if self.lat[a] <= self.lat[b] else b

    def feedback(self, peer: int, latency_s: float) -> None:
        with self._lock:
            self.lat[peer] += self.alpha * (latency_s - self.lat[peer])
