"""AdamW with global-norm clipping, built from scratch (no
``torch.optim``), the JAX package's ``src/repro/optim/adamw.py``.

The update is the reference's, leaf by leaf, but in place: params, m and
v are rewritten where they lie (as ``torch.optim`` does) rather than
returned as new trees, because a full-width model's training state (16
bytes a parameter: weights, gradients, m, v) leaves no room on the card
for a second copy of the moments.

Which leaves are decayed: the reference decays a leaf when
``p.ndim > 1``, and its layer leaves carry a leading group axis (the
stacked layers of ``lax.scan``), so every per-layer norm scale and bias,
(G, d) there, *is* decayed while ``final_norm``'s (d,) is not.  The
port's layers are a flat list, a per-layer norm (d,); :func:`decays`
keeps the reference's choice (ROADMAP C.16): a leaf under ``layers`` or
``enc_layers`` counts as stacked.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.distributed.sharding import P
from repro_torch.tree import leaves, leaves_with_paths, map_tree

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "decays", "opt_state_specs", "STACKED"]

#: the port's flat layer lists, each standing for a stacked tree of the
#: reference's (``stacks``, ``enc_stack``)
STACKED = ("layers", "enc_layers")


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params) -> Dict[str, Any]:
    """Zero float32 moments of the params' structure and an int32 step
    counter, on the params' device."""
    first = leaves(params)[0]
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return {
        "m": map_tree(zeros, params),
        "v": map_tree(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def opt_state_specs(param_specs) -> Dict[str, Any]:
    return {"m": param_specs, "v": param_specs, "step": P()}


def global_norm(tree) -> torch.Tensor:
    """√(Σ over leaves of Σ x²), float32, summed leaf by leaf in the
    tree's order."""
    total = 0.0
    for leaf in leaves(tree):
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(torch.as_tensor(total))


def decays(path, p: torch.Tensor) -> bool:
    """Whether ``p`` (at ``path`` in the params) gets weight decay: the
    reference's ``p.ndim > 1`` on its stacked shapes (module docstring)."""
    return p.dim() > 1 or any(k in STACKED for k in path)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, opt_state, params, lr_scale=1.0
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  Returns (params, opt_state, metrics):
    the same params and moment tensors, rewritten, the step counter
    advanced, and ``{"grad_norm", "lr"}``."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12),
                       max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, step.float())
    bc2 = 1.0 - torch.pow(b2, step.float())
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=gnorm.device)

    flat_g = leaves(grads)
    flat_m = leaves(opt_state["m"])
    flat_v = leaves(opt_state["v"])
    for (path, p), g, m, v in zip(leaves_with_paths(params), flat_g, flat_m,
                                  flat_v):
        g = g.float() * clip
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if decays(path, p):
            upd = upd + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * upd)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
