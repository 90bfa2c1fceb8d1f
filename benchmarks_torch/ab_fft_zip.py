"""FFT and ZIP kernels of two trees timed in turns on one card.

    python benchmarks_torch/ab_fft_zip.py --base DIR [--main] [--out FILE]

``DIR`` is another checkout of this repository (for example the parent
commit unpacked with ``git archive`` into a directory ``.gitignore``
lists).  Four processes run one after another -- base, this tree, this
tree, base -- and each builds its own tree's kernels and runs this
tree's ``chip_smoke.phase_timing`` over them: the same measurements
(call, one call + synchronise, enqueue, device time, and the library
call's) at the same shapes, on the same card, within one call (FFT
shapes past a tree's largest N are left out on its side).  Each process
also hashes its FFT kernel's output for seeded inputs at every power of
two up to 8192 (1, 3 and 128 rows, forward and inverse); the script
fails unless the four runs give the same bits.  With
``--main`` each process then also drives the radar path
(``chip_smoke.phase_main``, after one small warm-up run) and reports each
app's wall seconds per policy and the runtime's measured compute seconds
per fft/ifft/zip task.  Prints one line per (kernel, rows, N) and per app
with each side's mean of its two runs, and writes every record to
``--out`` (JSON).  Needs a CUDA device.
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
from repro_torch.kernels.fft import fft as F
from repro_torch.kernels.fft import ops as fft_ops
assert F.__file__.startswith(sys.argv[1]), F.__file__
import chip_smoke
_build.library()
chip_smoke.FFT_TIMED = tuple(s for s in chip_smoke.FFT_TIMED
                             if s[1] <= F.MAX_N)
gen = torch.Generator(device="cuda").manual_seed(0)
digests = {}
for p in range(1, 14):
    for rows in (1, 3, 128):
        x = torch.randn(rows, 1 << p, dtype=torch.complex64, device="cuda",
                        generator=gen)
        for fwd in (True, False):
            y = fft_ops.fft(x, fwd).cpu().numpy()
            digests[f"{1 << p}/{rows}/{int(fwd)}"] = hashlib.sha256(
                y.tobytes()).hexdigest()
out = {"timing": chip_smoke.phase_timing(torch.device("cuda", 0)),
       "fft_digests": digests}
if sys.argv[3] == "main":
    chip_smoke.phase_main(None, fft_sizes=(64,), fzf_sizes=(64,),
                          zip_sizes=(128,), pd=(4, 128), sar_scale=64,
                          session_chains=1, session_n=64, reps=1)
    out["main"] = chip_smoke.phase_main(None)[0]
print("AB_RECORDS " + json.dumps(out))
"""

KEYS = ("kernel_ms", "kernel_sync_ms", "kernel_enqueue_ms", "kernel_device_ms",
        "library_ms", "library_sync_ms", "library_enqueue_ms",
        "library_device_ms", "plain_ms", "bound_ms")


def run_side(tree: Path, main: bool) -> dict:
    out = subprocess.run([sys.executable, "-c", _CHILD, str(tree), str(ROOT),
                          "main" if main else "-"],
                         capture_output=True, text=True, timeout=1800)
    if out.returncode != 0:
        raise SystemExit(f"{tree}: exit {out.returncode}\n{out.stderr[-4000:]}")
    line = next(ln for ln in out.stdout.splitlines()
                if ln.startswith("AB_RECORDS "))
    return json.loads(line[len("AB_RECORDS "):])


def mean(xs):
    xs = [x for x in xs if x is not None]
    return sum(xs) / len(xs) if xs else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, type=Path)
    ap.add_argument("--main", action="store_true",
                    help="also drive the radar path in each process")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "ab_fft_zip.json")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("ab_fft_zip: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    order = [("base", args.base.resolve()), ("change", ROOT),
             ("change", ROOT), ("base", args.base.resolve())]
    runs = [(side, run_side(tree, args.main)) for side, tree in order]
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": smi, "order": [s for s, _ in runs],
                                    "runs": [r for _, r in runs]}, indent=1))
    print(f"card: {smi}; order: base, change, change, base; each cell the "
          f"mean of a side's two runs, ms")
    digests = [r["fft_digests"] for _, r in runs]
    differ = sorted(k for k in digests[0]
                    if len({d.get(k) for d in digests}) != 1)
    print(f"fft bits: {len(digests[0]) - len(differ)} of {len(digests[0])} "
          f"cases (N 2..8192) identical across the four runs")
    timing = [(side, {(r["kernel"], r["rows"], r["n"]): r
                      for r in rec["timing"]}) for side, rec in runs]
    shapes = list(dict.fromkeys(key for _, recs in timing for key in recs))
    for key in shapes:
        cells = {side: {k: mean([recs[key].get(k) for s, recs in timing
                                 if s == side and key in recs])
                        for k in KEYS} for side in ("base", "change")}
        print(json.dumps({"kernel": key[0], "rows": key[1], "n": key[2],
                          **cells}))
    if args.main:
        mains = [(side, r["main"]) for side, r in runs]
        for i, app0 in enumerate(mains[0][1]):
            line = {"app": app0["app"]}
            for side in ("base", "change"):
                recs = [m[i] for s, m in mains if s == side]
                line[side] = {
                    policy: {
                        "wall_s": mean([r[policy]["wall_s"] for r in recs]),
                        "task_compute_median_us": {
                            op: mean([r[policy]["task_compute_us"]
                                      .get(op, {}).get("median_us")
                                      for r in recs])
                            for op in ("fft", "ifft", "zip")}}
                    for policy in ("reference", "rimms")}
            print(json.dumps(line))
    if differ:
        print(f"fft output differs between the trees at {differ}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
