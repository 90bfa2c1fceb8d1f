"""The mLSTM backward kernels of two trees timed in turns on one card.

    python benchmarks_torch/ab_mlstm_bwd.py --base DIR [--out FILE]

``DIR`` is another checkout of this repository (for example the parent
commit unpacked with ``git archive`` into a directory ``.gitignore``
lists).  Four processes run one after another -- base, this tree, this
tree, base -- and each builds its own tree's kernels, then:

* hashes the mLSTM forward's h for seeded inputs at ``chip_smoke.py``
  phase 3's mLSTM shapes (``MLSTM_SWEEP`` and ``MLSTM_TIMED``, without
  and with grad); the script fails unless the four runs give the same
  bits;
* at ``MLSTM_BWD_TIMED`` calls its tree's ``mlstm_backward_kernel`` on
  its own forward's saved tensors and times it: the call (CUDA events),
  the device time by kernel (profiler, ``chip_smoke._device_ms_by_kernel``:
  whole or not measured) and their sum, and forward + backward through
  ``mlstm_chunkwise``; and holds its gradients against its tree's
  ``mlstm_backward_plain`` (max |err| / max |g| per gradient).

A side skips the shapes whose chunk its tree does not take
(``MAX_CHUNK``), and the runs are compared on the shapes every side ran.
Prints one line per shape and side with each side's two runs, and
writes every record to ``--out`` (JSON).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_CHILD = r"""
import hashlib, json, sys
sys.path.insert(0, sys.argv[1] + "/src")
sys.path.insert(1, sys.argv[2])
import torch
# this side's package before chip_smoke, which puts its own src first
from repro_torch.kernels import _build
from repro_torch.kernels.mlstm import mlstm as ML
from repro_torch.kernels.mlstm import ops as MO
assert ML.__file__.startswith(sys.argv[1]), ML.__file__
import chip_smoke
_build.library()
dev = torch.device("cuda", 0)
inp = chip_smoke.Inputs(dev, 3)
digests = {}
for B, S, H, m, c in chip_smoke.MLSTM_SWEEP + chip_smoke.MLSTM_TIMED:
    ins = inp.mlstm(B, S, H, m)  # drawn on every side: the same inputs
    if c > ML.MAX_CHUNK:  # a tree that takes only shorter chunks
        continue
    leaves = [t.clone().requires_grad_(True) for t in ins]
    for grad, args in (("no_grad", ins), ("grad", leaves)):
        h = MO.mlstm_chunkwise(*args, chunk=c).detach()
        digests[f"B{B} S{S} H{H} m{m} chunk{c} {grad}"] = hashlib.sha256(
            h.cpu().numpy().tobytes()).hexdigest()
timing = []
for B, S, H, m, c in chip_smoke.MLSTM_BWD_TIMED:
    if c > ML.MAX_CHUNK:
        continue
    ins = chip_smoke.Inputs(dev, S + m).mlstm(B, S, H, m)
    dh = chip_smoke.Inputs(dev, 1).normal(B, S, H, m)
    with torch.no_grad():
        saved = ML.mlstm_kernel(*ins, chunk=c, save=True)
    leaves = [t.clone().requires_grad_(True) for t in ins]

    def bwd():
        return ML.mlstm_backward_kernel(*ins, *saved, dh, chunk=c)

    def both():
        return torch.autograd.grad(MO.mlstm_chunkwise(*leaves, chunk=c),
                                   leaves, dh)

    got = bwd()
    want = ML.mlstm_backward_plain(*ins, *saved, dh, chunk=c)
    split = chip_smoke._device_ms_by_kernel(bwd, iters=5)
    timing.append({
        "shape": [B, S, H, m, c],
        "kernel_ms": chip_smoke._time_ms(bwd, 20, warmup=3),
        "device_ms_by_kernel": split,
        "kernel_device_ms": sum(split.values()) if split else None,
        "fwd_bwd_ms": chip_smoke._time_ms(both, 10, warmup=2),
        "rel_err_vs_plain": {n: float((g - w).abs().max() / w.abs().max())
                             for n, g, w in zip("q k v i f".split(), got,
                                                want)}})
print("AB_RECORDS " + json.dumps({"digests": digests, "timing": timing}))
"""


def run_side(tree: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", _CHILD, str(tree), str(ROOT)],
                         capture_output=True, text=True, timeout=1200)
    if out.returncode != 0:
        raise SystemExit(f"{tree}: exit {out.returncode}\n{out.stderr[-4000:]}")
    line = next(ln for ln in out.stdout.splitlines()
                if ln.startswith("AB_RECORDS "))
    return json.loads(line[len("AB_RECORDS "):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, type=Path,
                    help="another checkout of the repository")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    base = args.base.resolve()
    runs = [("base", base), ("main", ROOT), ("main", ROOT), ("base", base)]
    recs = [(side, run_side(tree)) for side, tree in runs]
    # the cases both trees take (a base may refuse a longer chunk)
    common = set.intersection(*(set(r["digests"]) for _, r in recs))
    first = recs[0][1]["digests"]
    for side, rec in recs[1:]:
        bad = sorted(k for k in common if rec["digests"][k] != first[k])
        if bad:
            raise SystemExit(f"forward h differs ({side}): {bad}")
    print(f"forward h: the same bits in all four runs at {len(common)} "
          f"(shape, grad) cases")
    shapes = [t["shape"] for t in recs[0][1]["timing"]
              if all(t["shape"] in [u["shape"] for u in r["timing"]]
                     for _, r in recs)]
    for shape in shapes:
        for side in ("base", "main"):
            rows = [next(u for u in rec["timing"] if u["shape"] == shape)
                    for s, rec in recs if s == side]
            print(f"{side} {shape}: "
                  + json.dumps({k: [r[k] for r in rows] for k in (
                      "kernel_ms", "kernel_device_ms", "fwd_bwd_ms",
                      "device_ms_by_kernel", "rel_err_vs_plain")}))
    if args.out:
        args.out.write_text(json.dumps(
            [{"side": s, **r} for s, r in recs], indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
