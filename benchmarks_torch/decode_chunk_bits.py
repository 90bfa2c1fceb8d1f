"""Whether the one-device decode attention could widen its bf16 caches to
float32 a piece at a time and keep its bits on this card.

    python benchmarks_torch/decode_chunk_bits.py [--out FILE]

``models/layers.py::decode_attention`` widens both whole caches to
float32 and runs its two einsums on them (the reference asks float32 of
the products).  This script runs that formulation on seeded bf16 queries
and caches at decode shapes of the repository's models, and the same
arithmetic with the caches widened a piece at a time: rows of 1, 2 and
B/2, one KV head at a time, and the scores over the keys in 8 chunks
(P·V a row at a time).  It prints, for every shape, which pieces give
the whole-cache formulation's bits, and writes them to ``--out`` (JSON).
Needs a CUDA device; float32 products without TF32, as the model paths
run them.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
#: (B, T, Hkv, G, hd): llama3-8b's and granite's decode widths at phase
#: 12-13's and the dry-run's batches, recurrentgemma-2b's window, whisper's
SHAPES = [(2, 2064, 8, 4, 128), (8, 4096, 8, 4, 128), (16, 32768, 8, 4, 128),
          (2, 2064, 8, 3, 64), (8, 32768, 8, 3, 64), (2, 2048, 1, 10, 256),
          (2, 1564, 20, 1, 64)]


def whole(q, k, v, kv_len):
    """``decode_attention``'s arithmetic on whole float32 caches."""
    hd = q.shape[-1]
    s = torch.einsum("bckgd,btkd->bkgct", q.float(), k.float()) / math.sqrt(
        hd)
    t = torch.arange(k.shape[1], device=q.device)
    mask = t[None, :] < kv_len[:, None]
    s = torch.where(mask[:, None, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgct,btkd->bckgd", p.to(q.dtype).float(),
                        v.float()).to(q.dtype)


def by_rows(q, k, v, kv_len, step):
    return torch.cat([whole(q[i:i + step], k[i:i + step], v[i:i + step],
                            kv_len[i:i + step])
                      for i in range(0, q.shape[0], step)])


def by_heads(q, k, v, kv_len):
    return torch.cat([whole(q[:, :, h:h + 1], k[:, :, h:h + 1],
                            v[:, :, h:h + 1], kv_len)
                      for h in range(q.shape[2])], dim=2)


def by_key_chunks(q, k, v, kv_len, n=8):
    """Scores over the keys in ``n`` chunks (widened a chunk at a time),
    P·V a row at a time."""
    hd = q.shape[-1]
    qf = q.float()
    s = torch.cat([torch.einsum("bckgd,btkd->bkgct", qf, c.float())
                   for c in torch.chunk(k, n, dim=1)], dim=-1) / math.sqrt(hd)
    t = torch.arange(k.shape[1], device=q.device)
    mask = t[None, :] < kv_len[:, None]
    s = torch.where(mask[:, None, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(q.dtype).float()
    return torch.cat([torch.einsum("bkgct,btkd->bckgd", p[i:i + 1],
                                   v[i:i + 1].float())
                      for i in range(q.shape[0])]).to(q.dtype)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "decode_chunk_bits.json")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"{card}; torch {torch.__version__}")
    res = {}
    for B, T, Hkv, G, hd in SHAPES:
        g = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn(B, 1, Hkv, G, hd, generator=g,
                        device=dev).to(torch.bfloat16)
        k = torch.randn(B, T, Hkv, hd, generator=g,
                        device=dev).to(torch.bfloat16)
        v = torch.randn(B, T, Hkv, hd, generator=g,
                        device=dev).to(torch.bfloat16)
        kv_len = torch.randint(T // 2, T + 1, (B,), generator=g, device=dev)
        want = whole(q, k, v, kv_len)
        row = {f"rows of {n}": torch.equal(by_rows(q, k, v, kv_len, n), want)
               for n in sorted({1, 2, max(1, B // 2)})}
        row["a head at a time"] = torch.equal(by_heads(q, k, v, kv_len), want)
        row["keys in 8 chunks"] = torch.equal(by_key_chunks(q, k, v, kv_len),
                                              want)
        res[str((B, T, Hkv, G, hd))] = row
        print(f"decode_chunk_bits (B, T, Hkv, G, hd) = {(B, T, Hkv, G, hd)}: "
              + ", ".join(f"{k} {'same' if ok else 'DIFFER'}"
                          for k, ok in row.items()), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "torch": torch.__version__,
                                    "shapes": res}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
