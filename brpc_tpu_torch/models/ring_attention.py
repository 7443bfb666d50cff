"""Ring attention — sequence-parallel attention with rotating KV blocks.
Port of brpc_tpu/models/ring_attention.py.

Sequences shard along the sequence axis; each peer holds one Q/K/V block,
and K/V blocks travel the ring (one put per hop) while every peer folds
each arriving block into its local queries with the online-softmax
accumulator.  Merging two blocks rescales both sides by
``exp(m_old - m_new)``, so the result equals full attention up to float
rounding.  Causal masking is position-aware across the ring: block j's
keys carry global positions ``j*L .. (j+1)*L``, so blocks from "future"
peers mask out entirely and the diagonal block applies the triangle.

Numerics follow the reference: scores and the weighted sum of values are
accumulated in float32 (bf16 inputs are widened, which makes each product
exact, as `preferred_element_type=float32` does), and the probabilities are
cast to the value type before the second product.  On a GPU the float32
products must not run in TF32: PyTorch's default
(`torch.backends.cuda.matmul.allow_tf32 = False`) keeps them in float32,
and the f32 tolerance (2e-5) depends on it.  The reference has no Pallas
kernel here; both products are `torch.matmul`, as the JAX version leaves
them to XLA.
"""

from __future__ import annotations

import torch

from brpc_tpu_torch.parallel import collectives as coll
from brpc_tpu_torch.parallel.fabric import Fabric, P

__all__ = ["ring_attention", "attention_reference"]

_NEG_INF = -1e30


def _block_scores(q, k, scale, causal, q_pos, k_pos):
    """Scaled scores of local queries against one KV block (+ causal mask):
    q [bh, sq, d], k [bh, sk, d] -> [bh, sq, sk] in float32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    return s


def _fold_block(acc, s, v):
    """Online-softmax fold of one block's scores/values into (m, l, o)."""
    m, l, o = acc
    m_new = torch.maximum(m, s.amax(dim=-1))
    # exp() of fully-masked rows underflows to 0 — no NaN path.
    p = torch.exp(s - m_new[..., None])
    correction = torch.exp(m - m_new)
    l_new = l * correction + p.sum(dim=-1)
    o_new = o * correction[..., None] + torch.matmul(
        p.to(v.dtype).float(), v.float())
    return m_new, l_new, o_new


def ring_attention(fabric: Fabric, axis: str = "link",
                   causal: bool = False):
    """Builds the SPMD ring-attention step over `fabric`.

    Returns ``fn(q, k, v) -> out`` where every tensor is
    ``[batch*heads, seq, head_dim]``, split along ``seq`` over `axis`
    (`fabric.put(x, None, axis, None)`); `out` matches `q`.
    """
    n = fabric.axis_size(axis)
    perm = [(i, (i + 1) % n) for i in range(n)]

    def spmd(q, k, v):
        my_id = coll.axis_index(axis)  # 0-dim int32 on the device
        bh, sq, d = q.shape
        scale = 1.0 / (d ** 0.5)
        iota = torch.arange(sq, dtype=torch.int32, device=q.device)
        q_pos = my_id * sq + iota

        def fold(acc, kv, owner):
            k_blk, v_blk = kv
            s = _block_scores(q, k_blk, scale, causal, q_pos,
                              owner * sq + iota)
            return _fold_block(acc, s, v_blk)

        acc = (
            torch.full((bh, sq), _NEG_INF, dtype=torch.float32,
                       device=q.device),
            torch.zeros((bh, sq), dtype=torch.float32, device=q.device),
            torch.zeros((bh, sq, d), dtype=torch.float32, device=q.device),
        )
        # Hop 0: the local block, in place.
        kv = (k, v)
        acc = fold(acc, kv, my_id)
        for hop in range(1, n):
            # One ring hop: our current block moves right, the left
            # neighbour's lands here.
            kv = coll.ppermute(kv, axis, perm)
            acc = fold(acc, kv, (my_id - hop + n) % n)
        m, l, o = acc
        # Fully-masked rows (degenerate shapes only: a causal query always
        # sees itself, so l >= 1 there).
        l = torch.where(l == 0, torch.ones_like(l), l)
        return (o / l[..., None]).to(q.dtype)

    shard = P(None, axis, None)
    return fabric.spmd(spmd, in_specs=(shard,) * 3, out_specs=shard)


def attention_reference(causal: bool = False):
    """Single-device oracle: plain full softmax attention."""

    def fn(q, k, v):
        d = q.shape[-1]
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / (d ** 0.5)
        if causal:
            sq, sk = s.shape[-2], s.shape[-1]
            mask = (torch.arange(sq, device=q.device)[:, None] >=
                    torch.arange(sk, device=q.device)[None, :])
            s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
        p = torch.softmax(s, dim=-1)
        return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)

    return fn
