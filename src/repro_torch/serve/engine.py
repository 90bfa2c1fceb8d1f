"""Batched serving engine on the RIMMS paged KV pool.

The production mapping of the paper: the KV cache is one preallocated
device pool; the RIMMS marking systems hand out page extents; a
sequence's pages are one ``fragment()``-style grab; block tables are the
resource pointers consumed by the paged-attention kernel.

The decode step calls the port's paged-attention op, which dispatches on
the tensors' device: the plain version (the reference oracle's dense
gather) on the CPU, the hand-written CUDA kernel on a GPU.  (The JAX
package's step calls its oracle on every device.)

Continuous-batching-lite: up to ``max_batch`` slots decode in lock-step;
finished sequences free their pages back to the pool and new requests
are admitted into the freed slots.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.paged_kv import PagedKVPool, token_slots, write_token
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.models import layers as L

__all__ = ["ServeEngine", "Request", "SUPPORTED_FAMILIES"]

#: full-attention dense decoder families the paged engines support.
SUPPORTED_FAMILIES = ("dense", "vlm")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in SUPPORTED_FAMILIES:
        raise ValueError(
            f"serve engine supports full-attention dense decoder "
            f"families {SUPPORTED_FAMILIES}, got {cfg.family!r}"
        )


class ServeEngine:
    """``device``: where the KV pool lives and the step runs — ``None``
    is CUDA (raising without it), ``"cpu"`` runs on CPU tensors.  The
    params must lie there too.  ``decode_steps`` counts the batched
    decode steps run, teacher-forced prefill steps included."""

    def __init__(self, cfg: ArchConfig, params, *, max_batch: int = 4,
                 page_size: int = 16, num_pages: int = 512,
                 max_pages_per_seq: int = 32, allocator: str = "bitset",
                 eos_id: Optional[int] = None, device=None):
        from repro_torch.core.runtime import resolve_device

        _check_family(cfg)
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.page_size = page_size
        self.max_pages = max_pages_per_seq
        self.max_batch = max_batch
        self.eos_id = eos_id
        # scratch=True reserves the sacrificial scratch page inside the
        # pool's own accounting: inactive slots' block tables point at
        # it, so their masked writes never corrupt a live sequence's
        # pages, and no tenant can free it or get billed for it.
        self.pool = PagedKVPool(num_pages=num_pages, page_size=page_size,
                                allocator=allocator, scratch=True)
        self.scratch_page = self.pool.scratch_page
        # one zero-filled pool per layer (init_pool_arrays' layout with a
        # leading layer axis), updated in place by the step
        shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads,
                 cfg.head_dim_)
        self.k_pools = torch.zeros(shape, dtype=L.cdtype(cfg),
                                   device=self.device)
        self.v_pools = torch.zeros_like(self.k_pools)
        # slot state (host side — RIMMS metadata lives on host, §3.2.2)
        self.block_tables = np.full(
            (max_batch, max_pages_per_seq), self.scratch_page, np.int32
        )
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.slot_pos = np.zeros((max_batch,), np.int32)
        self.slot_tok = np.zeros((max_batch,), np.int32)
        self._next_rid = 0
        self.waiting: List[Request] = []
        self.decode_steps = 0

    # -- request admission --------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int = 16) -> Request:
        if not prompt:
            raise ValueError("prompt must be non-empty")
        need = -(-(len(prompt) + max_new_tokens) // self.page_size)
        if need > self.max_pages:
            raise ValueError(
                f"request needs {need} pages "
                f"({len(prompt)} prompt + {max_new_tokens} new tokens) "
                f"but max_pages_per_seq is {self.max_pages}"
            )
        req = Request(self._next_rid, list(prompt), max_new_tokens)
        self._next_rid += 1
        self.waiting.append(req)
        return req

    def _admit(self) -> None:
        for slot in range(self.max_batch):
            if self.slot_req[slot] is not None or not self.waiting:
                continue
            req = self.waiting.pop(0)
            n_tokens = len(req.prompt) + req.max_new_tokens
            table = self.pool.alloc_sequence(req.rid, n_tokens)
            self.block_tables[slot, :] = self.scratch_page
            self.block_tables[slot, : len(table)] = table
            self.slot_req[slot] = req
            # prefill by teacher-forced decode over the prompt
            for i, tok in enumerate(req.prompt[:-1]):
                self._decode_one(slot, tok, i)
            self.slot_pos[slot] = len(req.prompt) - 1
            self.slot_tok[slot] = req.prompt[-1]

    def _decode_one(self, slot: int, token: int, pos: int) -> int:
        toks = self.slot_tok.copy()
        poss = self.slot_pos.copy()
        toks[slot], poss[slot] = token, pos
        nxt = self._step(toks, poss, active_mask=np.eye(1, self.max_batch,
                                                        slot, dtype=bool)[0])
        return int(nxt[slot])

    # -- decode ----------------------------------------------------------------
    def _step(self, tokens: np.ndarray, pos: np.ndarray, active_mask) -> np.ndarray:
        # torch.tensor copies: the step never reads a host buffer that the
        # engine rewrites afterwards
        dev = self.device
        lengths = torch.tensor(np.where(active_mask, pos + 1, 0).astype(np.int32),
                               device=dev)
        nxt, self.k_pools, self.v_pools = _paged_decode_step(
            self.cfg, self.params, self.k_pools, self.v_pools,
            torch.tensor(self.block_tables, device=dev),
            torch.tensor(np.asarray(tokens, np.int32), device=dev),
            torch.tensor(np.asarray(pos, np.int32), device=dev), lengths,
        )
        self.decode_steps += 1
        return nxt.cpu().numpy()

    def step(self) -> int:
        """One lock-step decode over all active slots; returns #active."""
        self._admit()
        active = np.array([r is not None for r in self.slot_req])
        if not active.any():
            return 0
        nxt = self._step(self.slot_tok, self.slot_pos, active)
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            tok = int(nxt[slot])
            req.generated.append(tok)
            self.slot_pos[slot] += 1
            self.slot_tok[slot] = tok
            if len(req.generated) >= req.max_new_tokens or tok == self.eos_id:
                req.done = True
                self.pool.free_sequence(req.rid)
                self.slot_req[slot] = None
                # re-point the idle slot at the scratch page so its
                # masked writes can't land in pages the pool recycles.
                self.block_tables[slot, :] = self.scratch_page
        return int(active.sum())

    def run(self, max_steps: int = 1000) -> None:
        for _ in range(max_steps):
            if self.step() == 0 and not self.waiting:
                break


@torch.inference_mode()  # less host work per torch call than no_grad
def _paged_decode_step(cfg, params, k_pools, v_pools, block_tables,
                       tokens, pos, lengths):
    """One batched paged decode step for dense-family configs.  The pools
    (n_layers, P, page, Hkv, hd) are written in place and returned.  The
    RoPE table and the scatter indices are made once for all layers."""
    x = L.embed_tokens(cfg, params["embed"], tokens[:, None],
                       pos[:, None] if cfg.pos_embed == "learned" else None)
    B = x.shape[0]
    dims = L.attn_dims(cfg)
    table = (L.rope_table(pos[:, None], dims.head_dim, cfg.rope_theta)
             if cfg.pos_embed == "rope" else None)
    slots = token_slots(block_tables, pos, k_pools.shape[2])
    for li, p in enumerate(params["layers"]):
        h = L.norm_apply(cfg, p["norm1"], x)
        q, k, v = L._project_qkv(cfg, p["attn"], h, pos[:, None],
                                 rope_table=table)
        kp = write_token(k_pools[li], block_tables, pos, k[:, 0],
                         slots=slots)
        vp = write_token(v_pools[li], block_tables, pos, v[:, 0],
                         slots=slots)
        attn = paged_attention(
            q[:, 0].reshape(B, dims.n_q, dims.head_dim).contiguous(),
            kp, vp, block_tables, lengths,
        ).reshape(B, 1, dims.n_q * dims.head_dim)
        x = x + attn @ p["attn"]["wo"].to(x.dtype)
        h = L.norm_apply(cfg, p["norm2"], x)
        x = x + L.mlp_apply(cfg, p["mlp"], h)
    x = L.norm_apply(cfg, params["final_norm"], x)
    logits = L.lm_logits(cfg, params["embed"], x)
    nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
    return nxt, k_pools, v_pools
