"""Plain PyTorch version of the flash_attention kernel, in the kernel's own
formulation (that of the JAX package's ``_attn_kernel``, not of its
oracle ``flash_attention/ref.py``, whose causal mask is aligned
bottom-right and agrees with the kernel only at Tq == Tk):

- s = (q . k) * D**-0.5 in fp32; with ``causal`` the mask ``q_pos >=
  k_pos`` aligned top-left, masked scores at -1e30 (without it, the TPU
  kernel's ``causal=False`` branch, no mask: the keys are the Tk that
  exist, so a ragged T adds none);
- an online softmax over KV blocks of ``BLOCK_K`` keys: running max m,
  running sum l of the fp32 p, fp32 accumulator ``acc * alpha +
  p.to(v.dtype) @ v`` (p cast to the value dtype before the PV product);
- o = acc / l with l == 0 read as 1, cast to q's dtype once.

GQA maps query head h to KV head h // (Hq / Hkv), as the kernel does; K
and V are not repeated."""

from __future__ import annotations

import torch

NEG_INF = -1e30
BLOCK_K = 64        # keys per online-softmax step, the kernel's BKV


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q (B, Hq, Tq, D); k, v (B, Hkv, Tk, D), Hq % Hkv == 0 -> (B, Hq, Tq, D)."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    qf = q.float().reshape(b, hkv, g, tq, d)
    kf, vf = k.float(), v.float()
    m = torch.full((b, hkv, g, tq, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, g, tq, 1), device=q.device)
    acc = torch.zeros((b, hkv, g, tq, d), device=q.device)
    q_pos = torch.arange(tq, device=q.device)
    for k0 in range(0, tk, BLOCK_K):
        kj, vj = kf[:, :, k0:k0 + BLOCK_K], vf[:, :, k0:k0 + BLOCK_K]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kj) * scale
        if causal:
            k_pos = k0 + torch.arange(kj.shape[2], device=q.device)
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), vj)
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l).to(q.dtype).reshape(b, hq, tq, d)
