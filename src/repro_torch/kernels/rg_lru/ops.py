"""Public RG-LRU op: (B, S, D) float32, with the reference's
``block_lanes`` clamp."""

from __future__ import annotations

import torch

from .._build import refuse_dtensor
from .rg_lru import (LANES, rg_lru_backward_kernel, rg_lru_backward_plain,
                     rg_lru_kernel, rg_lru_plain)


def _clamp_lanes(block_lanes: int, d: int) -> int:
    """The reference's clamp: the largest multiple of LANES that is at
    most ``block_lanes`` and divides D padded to LANES."""
    dp = d + (-d) % LANES
    ok = [lane for lane in range(LANES, min(int(block_lanes), dp) + 1, LANES)
          if dp % lane == 0]
    if not ok:
        raise ValueError(
            f"block_lanes {block_lanes} admits no lane tile: it must be at "
            f"least {LANES}")
    return max(ok)


class _RGLRUScan(torch.autograd.Function):
    """The scan with its backward by device: a CUDA tensor's forward and
    backward launch the kernels, a CPU tensor's run the plain versions.
    The forward keeps a, h0 and its own h_seq; the backward does not run
    the recurrence again."""

    @staticmethod
    def forward(ctx, a, b, h0, lanes):
        if a.is_cuda:
            hs, hn = rg_lru_kernel(a, b, h0, block_lanes=lanes)
        else:
            hs, hn = rg_lru_plain(a, b, h0)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(a, h0, hs)
        ctx.lanes = lanes
        return hs, hn

    @staticmethod
    def backward(ctx, dhs, dhn):
        a, h0, hs = ctx.saved_tensors
        dhs = (torch.zeros_like(hs) if dhs is None
               else dhs.to(torch.float32).contiguous())
        dhn = (torch.zeros_like(h0) if dhn is None
               else dhn.to(torch.float32).contiguous())
        if a.is_cuda:
            da, db, dh0 = rg_lru_backward_kernel(a, hs, h0, dhs, dhn,
                                                 block_lanes=ctx.lanes)
        else:
            da, db, dh0 = rg_lru_backward_plain(a, hs, h0, dhs, dhn)
        return da, db, dh0, None


def rg_lru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor, *,
                block_lanes: int = LANES):
    """h_t = a_t · h_{t-1} + b_t over a, b: (B, S, D) and h0: (B, D),
    all float32.  Returns (h_seq (B, S, D), h_final (B, D)).

    CUDA tensors go to the hand-written kernel; CPU tensors to the plain
    chunked scan (the kernel's arithmetic); anything else raises.  Both
    are differentiable through an autograd ``Function`` whose backward
    goes the same way: the backward kernel, or its plain version on the
    CPU.  ``block_lanes`` tunes lanes per
    thread block (bit-identical across values); it is clamped down to
    the largest multiple of 128 dividing D padded to 128, as the
    reference clamps it, and D itself is never padded."""
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"rg_lru_scan takes torch.Tensors, {name} is "
                            f"{type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"rg_lru_scan takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"rg_lru_scan takes contiguous tensors ({name})")
        if t.device != a.device:
            raise ValueError(f"rg_lru_scan devices differ: {name} on "
                             f"{t.device}, a on {a.device}")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rg_lru_scan needs a, b of one (B, S, D) shape, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    batch, _, d = a.shape
    if tuple(h0.shape) != (batch, d):
        raise ValueError(f"rg_lru_scan needs h0 of shape {(batch, d)}, got "
                         f"{tuple(h0.shape)}")
    lanes = _clamp_lanes(block_lanes, d)
    if a.is_cuda:
        refuse_dtensor("rg_lru", a, b, h0)
    if a.is_cuda or a.device.type == "cpu":
        return _RGLRUScan.apply(a, b, h0, lanes)
    raise ValueError(f"rg_lru_scan has no kernel for device {a.device}")
