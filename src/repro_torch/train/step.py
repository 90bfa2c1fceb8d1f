"""Train, prefill and serve steps, the JAX package's
``src/repro/train/step.py`` on torch: the gradient is ``loss.backward()``
on float32 master weights, remat is per-layer
``torch.utils.checkpoint`` (:meth:`repro_torch.models.model_api.Model.loss`),
and the AdamW update runs in place."""

from __future__ import annotations

import torch

from repro_torch.models.model_api import Model
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.tree import leaves, map_tree

__all__ = ["build_train_step", "build_serve_step", "build_prefill_step"]


def build_train_step(model: Model, opt_cfg: AdamWConfig = AdamWConfig(),
                     *, remat: bool = True, microbatches: int = 1):
    """fwd+bwd+AdamW.  ``microbatches > 1`` accumulates float32 gradients
    over ``microbatches`` equal slices of the batch (rows in order) and
    divides by their number: the same tokens per step, 1/k of the
    activation memory.

    ``train_step(params, opt_state, batch)`` → (params, opt_state,
    metrics); params and moments are rewritten in place, ``metrics``
    holds ``loss``, ``grad_norm`` and ``lr`` (0-d tensors)."""

    def _grad_of(p):
        if p.grad is None:  # a leaf the loss does not reach
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        # the sum over microbatches, divided in place (no second copy)
        return p.grad.div_(microbatches) if microbatches > 1 else p.grad

    def grads_of(params, batch):
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
            p.grad = None
        try:
            if microbatches == 1:
                loss = model.loss(params, batch, remat=remat)
                loss.backward()
                loss = loss.detach()
            else:
                k = microbatches
                loss = 0.0
                for i in range(k):
                    part = {n: a.reshape(k, a.shape[0] // k, *a.shape[1:])[i]
                            for n, a in batch.items()}
                    l = model.loss(params, part, remat=remat)
                    l.backward()  # sums into each leaf's float32 .grad
                    loss = loss + l.detach()
                loss = loss / k
            grads = map_tree(_grad_of, params)
        finally:
            for p in flat:
                p.requires_grad_(False)
                p.grad = None
        return loss, grads

    def train_step(params, opt_state, batch):
        loss, grads = grads_of(params, batch)
        # evaluated at the step being taken (1-based): warmup must not
        # zero out the very first update
        lr_scale = cosine_schedule(opt_state["step"] + 1)
        params, opt_state, metrics = adamw_update(opt_cfg, grads, opt_state,
                                                  params, lr_scale)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def build_serve_step(model: Model):
    """One decode step: greedy next token + updated caches."""

    @torch.no_grad()  # not inference_mode: DTensors refuse it
    def serve_step(params, caches, token, pos):
        logits, caches = model.decode_step(params, caches, token, pos)
        return torch.argmax(logits, dim=-1).to(torch.int32), caches

    return serve_step


def build_prefill_step(model: Model, max_len: int):
    @torch.no_grad()
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_len)

    return prefill_step
