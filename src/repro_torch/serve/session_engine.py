"""Continuous-batching LLM serving on the RIMMS Session.

The legacy :class:`~repro_torch.serve.engine.ServeEngine` manages its KV
pool by hand: two bare device tensors, no quotas, no pressure handling,
no telemetry.  This engine runs the same continuous-batching decode loop
*through* the runtime instead:

* every tenant is a QoS client on a :class:`~repro_torch.core.api.Session`
  — weighted DRR admission, bounded in-flight windows, per-tenant decode
  latency percentiles and SLO burn rates in ``qos_report()``;
* the KV cache is a :class:`~repro_torch.core.kv_manager.KVManager`: page
  groups are Session buffers in the device arena, with per-tenant page
  quotas enforced by the tenant-aware paged pool;
* prefill and decode are distinct registered ops (``llm_prefill``
  throughput-bound, ``llm_decode`` latency-sensitive) with their own QoS
  weights/windows, so placement, staging, spans, and divergence
  telemetry all come from the runtime for free;
* each submission stages only the page groups its block tables
  reference: cold groups become LRU eviction victims under arena
  pressure, spill to host through the existing coherence path
  (dirty write-back), and re-stage transparently on the next decode
  step that touches them — there is no serving-specific copy code.

Token streams are bit-identical to the legacy engine on the same
submission order: the per-tenant masked sub-steps write the same values
into the same pages (KV entries are deterministic, idempotent functions
of ``(token, position, params)``, and every per-row output depends only
on that row's inputs plus its own pages).

bfloat16 groups travel as int16 raw bits (see
:mod:`repro_torch.core.kv_manager`); the ops view them as bfloat16 and
return them as int16.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.api import OpRegistry, Session, op
from repro_torch.core.kv_manager import KVManager
from repro_torch.models import layers as L

from .engine import Request, _check_family, _paged_decode_step

__all__ = ["SessionServeEngine", "TenantRequest"]


@dataclasses.dataclass
class TenantRequest(Request):
    tenant: str = "default"


def _tensor(x) -> torch.Tensor:
    """A kernel operand as a tensor: a host array (a cpu PE's operand)
    becomes a CPU tensor of its own — the host space rewrites its arrays
    in place, so no view of one may outlive the call."""
    return x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))


def _group_in(x, dtype: torch.dtype) -> torch.Tensor:
    t = _tensor(x)
    return t.view(dtype) if t.dtype != dtype else t  # int16 raw bits


def _group_out(t: torch.Tensor, host: bool):
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy() if host else t


def _split(pool: torch.Tensor, gp: int):
    """Back into page groups, each a tensor of its own (a view would keep
    the whole concatenated pool alive for as long as any group lives)."""
    return [g.contiguous() for g in pool.split(gp, dim=1)]


class SessionServeEngine:
    """Session-backed continuous-batching engine.

    Drop-in for :class:`~repro_torch.serve.engine.ServeEngine` plus
    tenancy: ``submit(prompt, max_new_tokens, tenant=...)`` queues a
    request under a QoS client; ``step()`` admits waiting requests
    (prefill tasks under the shared throughput-bound ``prefill`` client)
    and runs one lock-step decode as per-tenant latency-sensitive
    sub-steps.

    With no ``session`` the engine owns a fresh emulated SoC whose
    single device arena (``arena_bytes``) backs the KV groups —
    shrinking it below the total KV footprint makes cold sequences spill
    to host through the runtime's eviction path.  ``prefetch`` is off on
    the owned session: the closed decode loop serializes on its own
    results, and unprefetched staging keeps the replayed modeled gates
    byte-deterministic.  ``device`` is passed to ``Session.emulated``:
    ``None`` is CUDA (raising without it), ``"cpu"`` runs on CPU tensors;
    the params must lie there.  ``decode_steps`` counts the batched
    decode steps run, teacher-forced prefill steps included.
    """

    def __init__(self, cfg: ArchConfig, params, *, session: Optional[Session] = None,
                 max_batch: int = 4, page_size: int = 16, num_pages: int = 512,
                 max_pages_per_seq: int = 32, pages_per_group: int = 8,
                 allocator: str = "bitset", eos_id: Optional[int] = None,
                 arena_bytes: int = 64 << 20, platform: Optional[str] = None,
                 kv_owner: str = "kv-cache",
                 decode_weight: float = 4.0, decode_window: int = 4,
                 prefill_weight: float = 1.0, prefill_window: int = 8,
                 device=None):
        _check_family(cfg)
        self.cfg = cfg
        self.params = params
        self.page_size = page_size
        self.max_pages = max_pages_per_seq
        self.max_batch = max_batch
        self.eos_id = eos_id
        self.decode_steps = 0
        self._decode_weight = decode_weight
        self._decode_window = decode_window

        self._registry = OpRegistry()
        self._register_kernels()
        if session is None:
            session = Session.emulated(
                platform, policy="rimms", scheduler="heft", n_cpu=0,
                accelerators=("gpu0",), registry=self._registry,
                prefetch=False, arena_bytes=arena_bytes, device=device,
            )
            self._owns_session = True
        else:
            # Rebind (not missing_only): the kernels close over *this*
            # engine's params — one serving engine per session at a time.
            self._registry.install(session.runtime,
                                   extend_supports=("cpu", "gpu"))
            self._owns_session = False
        self.session = session
        self.kv = KVManager(
            session, n_layers=cfg.n_layers, kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim_, num_pages=num_pages,
            page_size=page_size, pages_per_group=pages_per_group,
            dtype=L.cdtype(cfg), allocator=allocator, owner=kv_owner,
        )
        self._prefill_client = session.client(
            "prefill", weight=prefill_weight, window=prefill_window)
        self._tenants: Dict[str, object] = {}  # name -> SessionClient

        self.block_tables = np.full(
            (max_batch, max_pages_per_seq), self.kv.scratch_page, np.int32)
        self.slot_req: List[Optional[TenantRequest]] = [None] * max_batch
        self.slot_pos = np.zeros((max_batch,), np.int32)
        self.slot_tok = np.zeros((max_batch,), np.int32)
        self._next_rid = 0
        self.waiting: List[TenantRequest] = []

    # -- kernels -------------------------------------------------------------
    def _register_kernels(self) -> None:
        cfg = self.cfg
        dt = L.cdtype(cfg)

        def decode_kernel(ins, *, mask, n_groups):
            host = not isinstance(ins[0], torch.Tensor)
            tokens, pos, tables = (_tensor(x) for x in ins[:3])
            k_pool = torch.cat([_group_in(x, dt)
                                for x in ins[3:3 + n_groups]], dim=1)
            v_pool = torch.cat([_group_in(x, dt)
                                for x in ins[3 + n_groups:3 + 2 * n_groups]],
                               dim=1)
            active = torch.tensor(mask, device=pos.device)
            lengths = torch.where(active, pos + 1, 0).to(torch.int32)
            nxt, k_pool, v_pool = _paged_decode_step(
                cfg, self.params, k_pool, v_pool, tables, tokens, pos,
                lengths)
            self.decode_steps += 1
            gp = k_pool.shape[1] // n_groups
            groups = _split(k_pool, gp) + _split(v_pool, gp)
            return (nxt.numpy() if host else nxt,
                    *(_group_out(g, host) for g in groups))

        def prefill_kernel(ins, *, slot, prompt, base_toks, base_pos,
                           n_groups):
            host = not isinstance(ins[0], torch.Tensor)
            tables = _tensor(ins[0])
            dev = tables.device
            k_pool = torch.cat([_group_in(x, dt)
                                for x in ins[1:1 + n_groups]], dim=1)
            v_pool = torch.cat([_group_in(x, dt)
                                for x in ins[1 + n_groups:1 + 2 * n_groups]],
                               dim=1)
            toks = np.array(base_toks, np.int32)
            poss = np.array(base_pos, np.int32)
            onehot = np.eye(1, len(toks), slot, dtype=bool)[0]
            # Teacher-forced prefill: one masked decode step per prompt
            # token on the concatenated pool.  Each dispatch gets fresh
            # tensors (torch.tensor copies): the host arrays are rewritten
            # by the next iteration.
            for i, tok in enumerate(prompt):
                toks[slot], poss[slot] = tok, i
                lengths = torch.tensor(
                    np.where(onehot, poss + 1, 0).astype(np.int32), device=dev)
                _, k_pool, v_pool = _paged_decode_step(
                    cfg, self.params, k_pool, v_pool, tables,
                    torch.tensor(toks, device=dev),
                    torch.tensor(poss, device=dev), lengths)
                self.decode_steps += 1
            gp = k_pool.shape[1] // n_groups
            return tuple(_group_out(g, host)
                         for g in _split(k_pool, gp) + _split(v_pool, gp))

        op("llm_decode", kinds=("cpu", "gpu"), registry=self._registry,
           replace=True)(decode_kernel)
        op("llm_prefill", kinds=("cpu", "gpu"), registry=self._registry,
           replace=True)(prefill_kernel)

    # -- tenants -------------------------------------------------------------
    def tenant(self, name: str, *, weight: Optional[float] = None,
               window: Optional[int] = None,
               quota_pages: Optional[int] = None,
               slo_latency_s: Optional[float] = None,
               slo_target: Optional[float] = None):
        """Register (or update) a tenant: a QoS client for its decode
        tasks plus an optional KV page quota."""
        cl = self.session.client(
            name,
            weight=self._decode_weight if weight is None else weight,
            window=self._decode_window if window is None else window,
            slo_latency_s=slo_latency_s, slo_target=slo_target,
        )
        if name not in self._tenants:
            self._tenants[name] = cl
        if quota_pages is not None:
            self.kv.set_quota(name, quota_pages)
        return cl

    # -- request admission ---------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int = 16,
               tenant: str = "default") -> TenantRequest:
        if not prompt:
            raise ValueError("prompt must be non-empty")
        need = -(-(len(prompt) + max_new_tokens) // self.page_size)
        if need > self.max_pages:
            raise ValueError(
                f"request needs {need} pages "
                f"({len(prompt)} prompt + {max_new_tokens} new tokens) "
                f"but max_pages_per_seq is {self.max_pages}"
            )
        if tenant not in self._tenants:
            self.tenant(tenant)
        req = TenantRequest(self._next_rid, list(prompt), max_new_tokens,
                            tenant=tenant)
        self._next_rid += 1
        self.waiting.append(req)
        return req

    def _admit(self) -> None:
        from repro_torch.core.allocator import AllocError
        from repro_torch.core.qos import QuotaExceeded

        for slot in range(self.max_batch):
            if self.slot_req[slot] is not None:
                continue
            req = None
            # FIFO with quota skip: a tenant over its KV quota defers
            # (stays queued) without blocking other tenants' admissions.
            for i, cand in enumerate(self.waiting):
                n_tokens = len(cand.prompt) + cand.max_new_tokens
                try:
                    table = self.kv.alloc(cand.rid, n_tokens,
                                          tenant=cand.tenant)
                except QuotaExceeded:
                    self.session.metrics.counter(
                        "serve_quota_deferrals").inc()
                    continue
                except AllocError:
                    # Shared pool exhausted: clean admission backpressure
                    # (head-of-line, order-preserving), not corruption.
                    self.session.metrics.counter(
                        "serve_pool_backpressure").inc()
                    return
                req = self.waiting.pop(i)
                break
            if req is None:
                return
            self.block_tables[slot, :] = self.kv.scratch_page
            self.block_tables[slot, : len(table)] = table
            self.slot_req[slot] = req
            if len(req.prompt) > 1:
                self._submit_prefill(slot, req)
            self.slot_pos[slot] = len(req.prompt) - 1
            self.slot_tok[slot] = req.prompt[-1]

    def _submit_prefill(self, slot: int, req: TenantRequest) -> None:
        groups = self.kv.referenced_groups(self.block_tables)
        tables = self.kv.compact_tables(self.block_tables, groups)
        bufs = self.kv.buffers(groups)
        tb = self.session.malloc(tables.shape, np.int32,
                                 client=self._prefill_client)
        tb.data[...] = tables
        self._prefill_client.submit(
            "llm_prefill", [tb, *bufs], out=list(bufs),
            name=f"prefill#{req.rid}",
            slot=slot, prompt=tuple(req.prompt[:-1]),
            base_toks=tuple(int(t) for t in self.slot_tok),
            base_pos=tuple(int(p) for p in self.slot_pos),
            n_groups=len(groups),
        )
        self.session.free(tb)  # deferred to the prefill's completion

    # -- decode --------------------------------------------------------------
    def _decode_substep(self, mask: np.ndarray, client) -> np.ndarray:
        groups = self.kv.referenced_groups(self.block_tables)
        tables = self.kv.compact_tables(self.block_tables, groups)
        bufs = self.kv.buffers(groups)
        sess = self.session
        tok = sess.malloc((self.max_batch,), np.int32, client=client)
        tok.data[...] = self.slot_tok
        pos = sess.malloc((self.max_batch,), np.int32, client=client)
        pos.data[...] = self.slot_pos
        tb = sess.malloc(tables.shape, np.int32, client=client)
        tb.data[...] = tables
        nxt = sess.malloc((self.max_batch,), np.int32, client=client)
        futs = client.submit(
            "llm_decode", [tok, pos, tb, *bufs], out=[nxt, *bufs],
            mask=tuple(bool(m) for m in mask), n_groups=len(groups),
        )
        for b in (tok, pos, tb):
            sess.free(b)
        out = futs[0].result()
        sess.free(nxt)
        return out

    def step(self) -> int:
        """One lock-step decode over all active slots — submitted as one
        latency-sensitive sub-step per tenant present; returns #active."""
        self._admit()
        active = np.array([r is not None for r in self.slot_req])
        if not active.any():
            self.kv.publish_metrics()
            return 0
        n_active = int(active.sum())
        metrics = self.session.metrics
        for tname, client in self._tenants.items():
            slots = [s for s in range(self.max_batch)
                     if self.slot_req[s] is not None
                     and self.slot_req[s].tenant == tname]
            if not slots:
                continue
            mask = np.zeros((self.max_batch,), bool)
            mask[slots] = True
            nxt = self._decode_substep(mask, client)
            for slot in slots:
                req = self.slot_req[slot]
                tok = int(nxt[slot])
                req.generated.append(tok)
                metrics.counter("serve_tokens_generated").inc()
                self.slot_pos[slot] += 1
                self.slot_tok[slot] = tok
                if (len(req.generated) >= req.max_new_tokens
                        or tok == self.eos_id):
                    req.done = True
                    self.kv.free(req.rid)
                    self.slot_req[slot] = None
                    self.block_tables[slot, :] = self.kv.scratch_page
                    metrics.counter("serve_requests_completed").inc()
        self.kv.publish_metrics()
        return n_active

    def run(self, max_steps: int = 10000) -> None:
        for _ in range(max_steps):
            if self.step() == 0 and not self.waiting:
                break

    # -- reporting / lifecycle ----------------------------------------------
    def qos_report(self):
        """The session's deterministic QoS replay — per-tenant decode
        latency percentiles, SLO burn rates, fairness, metrics."""
        self.session.barrier()
        return self.session.qos_report()

    def close(self) -> None:
        if self._owns_session and not self.session.closed:
            self.session.close()

    def __enter__(self) -> "SessionServeEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
