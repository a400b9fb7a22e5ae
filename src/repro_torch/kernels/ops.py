"""The model's entry points to its kernels.

Counterpart of ``repro/kernels/ops.py``.  Each name reaches its
kernel's wrapper, which launches the hand-written CUDA kernel for CUDA
tensors (or raises) and takes the kernel's plain PyTorch version only
for CPU tensors; there is no knob that routes a CUDA tensor elsewhere.

- ``flash_attention(q, k, v, *, causal=True)``: q (B,H,S,hd), k/v
  (B,Hkv,T,hd) → (B,H,S,hd);
- ``decode_attention(q, k, v, pos)``: q (B,H,hd), k/v (B,Hkv,T,hd), pos
  (B,) int32 → (B,H,hd);
- ``decode_attention_partial(q, k, v, pos)``: the same over a shard of
  the cache split by the sequence, ``pos`` shard-local → out (B,H,hd)
  fp32 and the heads' log-sum-exp (B,H) fp32;
- ``rmsnorm_fused(x, g, eps=1e-6)``: RMSNorm over the last axis;
- ``ssd_scan(x, dt, a, bm, cm, *, chunk=256)``: x (B,S,H,P), dt (B,S,H)
  fp32, a (H,) fp32, bm/cm (B,S,N) → y (B,S,H,P) fp32, final state
  (B,H,P,N) fp32 (``chunk`` is the plain version's).

Each name is the differentiable entry of its kernel's module
(``*_fn``): it applies the kernel's ``torch.autograd.Function`` (forward:
the wrapper; backward: plain PyTorch math) where autograd records, and
calls the wrapper itself elsewhere, so serving launches what it did.
``decode_attention`` (K5) and its partial mode serve decoding only and
have no gradient.
"""

from __future__ import annotations

from .decode_attention import decode_attention, decode_attention_partial
from .flash_attention import flash_attention_fn as flash_attention
from .rmsnorm import rmsnorm_fn as rmsnorm_fused
from .ssd_scan import ssd_scan_fn as ssd_scan

__all__ = ["decode_attention", "decode_attention_partial", "flash_attention", "rmsnorm_fused",
           "ssd_scan"]
