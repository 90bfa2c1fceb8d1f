"""Whether two trees' kernels give the same bits on one card.

    python benchmarks_torch/ab_bits.py --base DIR [--out FILE]

``DIR`` is another checkout of this repository (for example the parent
commit unpacked with ``git archive`` into a directory ``.gitignore``
lists).  Four processes run one after another -- base, this tree, this
tree, base -- and each builds its own tree's kernels, then hashes the
outputs of seeded inputs (made on the card from a fixed seed, the same in
every run) at shapes both trees take:

* the mLSTM forward's h at ``chip_smoke.py`` phase 3's mLSTM shapes with
  a chunk of 128 or less (``MLSTM_SWEEP`` and ``MLSTM_TIMED``), without
  and with grad (``save``);
* flash attention at head widths 64 and 128 (``FLASH_SWEEP``, the model
  shape, causal and not, bf16 and float32);
* the FFT at every power of two from 2 to 2^21 (1 and 3 rows up to
  2^16, one above), and at every length of phase 3's ``FFT_ANY_N`` (3 to
  2^20 - 1, Bluestein's route) at phase 3's rows (``fft_any_rows``),
  forward and inverse.

Each run also times (CUDA events, 50 calls after 5) flash attention at
``FLASH_MODEL`` (bf16, float32) and the mLSTM forward at
``MLSTM_MODEL``, shapes both trees take.  Fails unless the four runs give
the same digest for every case.  Prints one line per kernel, and each
timed shape's four times, and writes every digest and time to ``--out``
(JSON).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

_CHILD = r"""
import hashlib, json, sys
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from repro_torch.kernels import _build
from repro_torch.kernels.fft import ops as FO
from repro_torch.kernels.flash_attention import ops as AO
from repro_torch.kernels.mlstm import ops as MO
assert MO.__file__.startswith(sys.argv[1]), MO.__file__
cases = json.loads(sys.argv[2])
_build.library()
dev = torch.device("cuda", 0)


def gen(seed):
    return torch.Generator(device=dev).manual_seed(seed)


def digest(t):
    return hashlib.sha256(t.detach().cpu().contiguous().view(torch.uint8)
                          .numpy().tobytes()).hexdigest()


out = {}
for B, S, H, m, c in cases["mlstm"]:
    g = gen(S + m + c)
    q = torch.randn(B, S, H, m, device=dev, generator=g)
    k = torch.randn(B, S, H, m, device=dev, generator=g) * 0.3
    v = torch.randn(B, S, H, m, device=dev, generator=g)
    ig = torch.rand(B, S, H, device=dev, generator=g) * 0.8 + 0.1
    lf = torch.log(torch.rand(B, S, H, device=dev, generator=g) * 0.45 + 0.5)
    ins = (q, k, v, ig, lf)
    leaves = [t.clone().requires_grad_(True) for t in ins]
    for mode, args in (("no_grad", ins), ("grad", leaves)):
        out[f"mlstm B{B} S{S} H{H} m{m} chunk{c} {mode}"] = digest(
            MO.mlstm_chunkwise(*args, chunk=c))
for B, S, Hq, Hkv, d, bq, bk, dt in cases["flash"]:
    dtype = getattr(torch, dt)
    g = gen(S + d + Hq)
    q = torch.randn(B, S, Hq, d, device=dev, generator=g).to(dtype)
    k = torch.randn(B, S, Hkv, d, device=dev, generator=g).to(dtype)
    v = torch.randn(B, S, Hkv, d, device=dev, generator=g).to(dtype)
    for causal in (True, False):
        out[f"flash B{B} S{S} Hq{Hq} Hkv{Hkv} d{d} bq{bq} bk{bk} {dt} "
            f"{'causal' if causal else 'full'}"] = digest(
            AO.flash_attention(q, k, v, causal=causal, block_q=bq,
                               block_k=bk))
for rows, n in cases["fft"]:
    g = gen(n + rows)
    x = torch.randn(rows, n, dtype=torch.complex64, device=dev, generator=g)
    kind = "fft" if n & (n - 1) == 0 else "bluestein"
    for fwd in (True, False):
        out[f"{kind} rows{rows} n{n} {'fwd' if fwd else 'inv'}"] = digest(
            FO.fft(x, fwd))
torch.cuda.synchronize()


def time_ms(fn, iters=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


times = {}
for B, S, Hq, Hkv, d, dt in cases["flash_timed"]:
    dtype = getattr(torch, dt)
    g = gen(1)
    q = torch.randn(B, S, Hq, d, device=dev, generator=g).to(dtype)
    k = torch.randn(B, S, Hkv, d, device=dev, generator=g).to(dtype)
    v = torch.randn(B, S, Hkv, d, device=dev, generator=g).to(dtype)
    times[f"flash B{B} S{S} Hq{Hq} Hkv{Hkv} d{d} {dt} causal"] = time_ms(
        lambda: AO.flash_attention(q, k, v))
for B, S, H, m, c in cases["mlstm_timed"]:
    g = gen(2)
    ins = [torch.randn(B, S, H, m, device=dev, generator=g)
           for _ in range(3)]
    ins += [torch.rand(B, S, H, device=dev, generator=g) * 0.8 + 0.1,
            torch.log(torch.rand(B, S, H, device=dev, generator=g) * 0.45
                      + 0.5)]
    times[f"mlstm B{B} S{S} H{H} m{m} chunk{c}"] = time_ms(
        lambda: MO.mlstm_chunkwise(*ins, chunk=c), iters=20)
print(json.dumps({"device": torch.cuda.get_device_name(0), "digests": out,
                  "ms": times}))
"""


def cases():
    import chip_smoke as cs

    mlstm = [list(t) for t in dict.fromkeys(cs.MLSTM_SWEEP + cs.MLSTM_TIMED)
             if t[4] <= 128]
    m = cs.FLASH_MODEL
    flash = [list(t[:7]) + [str(t[7])[6:]] for t in cs.FLASH_SWEEP]
    flash += [[m["B"], m["S"], m["Hq"], m["Hkv"], m["d"], 256, 256, dt]
              for dt in ("bfloat16", "float32")]
    fft = [[rows, 1 << p] for p in range(1, 22)
           for rows in ((1, 3) if p <= 16 else (1,))]
    fft += [[rows, n] for n in cs.FFT_ANY_N for rows in cs.fft_any_rows(n)]
    mm = cs.MLSTM_MODEL
    return {"mlstm": mlstm, "flash": flash, "fft": fft,
            "flash_timed": [[m["B"], m["S"], m["Hq"], m["Hkv"], m["d"], dt]
                            for dt in ("bfloat16", "float32")],
            "mlstm_timed": [[mm["B"], mm["S"], mm["H"], mm["m"],
                             mm["chunk"]]]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", type=Path, required=True)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "ab_bits.json")
    args = ap.parse_args()
    spec = json.dumps(cases())
    runs = []
    for side, tree in (("base", args.base), ("change", ROOT),
                       ("change", ROOT), ("base", args.base)):
        res = subprocess.run([sys.executable, "-c", _CHILD,
                              str(tree.resolve()), spec],
                             capture_output=True, text=True, cwd=str(ROOT))
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-8000:], file=sys.stderr)
            return 1
        runs.append((side, json.loads(res.stdout.strip().splitlines()[-1])))
    first = runs[0][1]["digests"]
    differ = sorted(k for _, r in runs[1:] for k in first
                    if r["digests"].get(k) != first[k])
    for kind in ("mlstm", "flash", "fft", "bluestein"):
        keys = [k for k in first if k.startswith(kind)]
        bad = [k for k in keys if k in differ]
        print(f"ab_bits {kind}: {len(keys)} cases, {len(keys) - len(bad)} "
              f"the same bits in all four runs" + (f"; differ: {bad}"
                                                   if bad else ""))
    for key in runs[0][1]["ms"]:
        print(f"ab_bits ms {key}: " + ", ".join(
            f"{s} {r['ms'][key]:.5g}" for s, r in runs))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"device": runs[0][1]["device"],
                                    "runs": [[s, r["digests"], r["ms"]]
                                             for s, r in runs],
                                    "differ": differ}, indent=1))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
