"""Dynamic W8A8 int8 products for inference (port of the JAX package's
``ops/quant.py``).

Both operands are quantized symmetrically to int8: activations per token
(per row), weights per output channel, each with ``scale = amax / 127``
(1 where a slice is all zero), ``round`` half to even and a clip to ±127.
The int32 accumulator is exact; it is rescaled in fp32 as
``acc * x_scale * w_scale (+ bias)`` and cast to the output dtype, the JAX
function's arithmetic in its order.

The product of the codes is :func:`int8_mm`: ``torch._int_mm`` on a CUDA
tensor, the plain version on a CPU tensor.  The JAX package computes it with
``dot_general`` outside any Pallas kernel, so no kernel of this repo stands
behind it.  ``torch._int_mm`` has shape rules on the card (more than 16
rows, inner and outer sizes multiples of 8); they are checked before the
call, and a shape that breaks them raises rather than taking another route.
:func:`int8_mm_plain` computes the same accumulator exactly on any device,
in float64 (exact while ``K * 127**2 < 2**53``).

Weights are in ``nn.Linear``'s layout, ``[out, in]``; the parameters are
never changed.  ``round`` has no gradient, so the route is inference-only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from multimodal_context_reasoning_torch.parallel.comm import all_reduce_

# float64 holds every integer below 2**53 exactly
_F64_MAX_K = (2 ** 53) // (127 * 127)


def quantize_symmetric(x: torch.Tensor, dim: int, *, group=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization along ``dim`` (reduced away in the scale).

    Returns ``(q, scale)`` with ``x ≈ q.float() * scale``, ``q`` in
    [-127, 127] and ``scale`` fp32 with ``dim`` kept as size 1.  With a
    process ``group`` ``x`` is this rank's block of ``dim`` and the amax is
    taken over the whole of it (a MAX all-reduce).
    """
    xf = x.float()
    amax = all_reduce_(xf.abs().amax(dim=dim, keepdim=True), group, dist.ReduceOp.MAX)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def check_int_mm(xq: torch.Tensor, wq: torch.Tensor) -> None:
    """Raise ``ValueError`` with the shapes where ``torch._int_mm``'s rules
    on the card fail: more than 16 rows, inner and outer sizes multiples of
    8."""
    rows, k = xq.shape
    n = wq.shape[0]
    if rows <= 16 or k % 8 or n % 8:
        raise ValueError(
            f"torch._int_mm needs more than 16 rows and inner and outer sizes that are "
            f"multiples of 8; got x [{rows}, {k}] · weight [{k}, {n}]")


def int8_mm_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int32 accumulator ``xq [R, K] · wq [N, K]ᵀ`` on any device, as
    a float64 product."""
    if xq.shape[1] > _F64_MAX_K:
        raise ValueError(f"inner size {xq.shape[1]} > {_F64_MAX_K}: float64 is not exact")
    return (xq.double() @ wq.double().t()).to(torch.int32)


def int8_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int32 accumulator ``xq [R, K] · wq [N, K]ᵀ``: ``torch._int_mm`` on a
    CUDA tensor (after :func:`check_int_mm`), the plain version on a CPU
    tensor."""
    if not xq.is_cuda:
        return int8_mm_plain(xq, wq)
    check_int_mm(xq, wq)
    return torch._int_mm(xq.contiguous(), wq.contiguous().t())


def int8_matmul(
    x: torch.Tensor,                       # [..., IN] float
    weight: Optional[torch.Tensor],        # [OUT, IN] float (nn.Linear layout)
    bias: Optional[torch.Tensor] = None,   # [OUT]
    out_dtype: torch.dtype = torch.float32,
    *,
    weight_q: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    plain: bool = False,
    group=None,
) -> torch.Tensor:
    """``x @ weight.T (+ bias)`` with both sides dynamically quantized to
    int8.  ``weight_q`` is ``quantize_symmetric(weight, 1)`` computed
    beforehand (the same bits as quantizing here); ``plain`` takes
    :func:`int8_mm_plain` on any device.  With a process ``group`` the
    product is row-parallel: ``x`` and ``weight`` hold this rank's block
    of IN, both scales cover all of IN and the int32 accumulators are
    summed over the group (exact), so every rank gets the whole result."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    xq, xs = quantize_symmetric(x2, dim=1, group=group)             # [R, IN], [R, 1]
    wq, ws = (weight_q if weight_q is not None
              else quantize_symmetric(weight, dim=1, group=group))
    acc = all_reduce_((int8_mm_plain if plain else int8_mm)(xq, wq), group)  # [R, OUT] int32
    y = acc.float() * xs * ws.view(1, -1)
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype).reshape(*shape[:-1], wq.shape[0])
