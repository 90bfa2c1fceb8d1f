"""Whether two trees' model paths give the same bits on one card: prefill
and greedy decode of llama3-8b, granite-moe-3b-a800m, xlstm-350m and
recurrentgemma-2b at full width.

    python benchmarks_torch/ab_decode_bits.py --base DIR [--out FILE]

``DIR`` is another checkout of this repository (for example the parent
commit unpacked with ``git archive`` into a directory ``.gitignore``
lists).  Four processes run one after another -- base, this tree, this
tree, base -- and each builds each model at full width and ``LAYERS``
layers in bfloat16 on the card (random weights from ``Model.init`` with
a generator seeded 0), prefills a seeded 2 x ``PROMPT`` prompt with
``Model.prefill`` and takes ``STEPS`` greedy steps with
``Model.decode_step``, hashing the prefill's logits and caches, every
step's logits and the last step's caches.  A tree whose
``decode_step`` takes ``donate`` also runs the steps again with the
caches donated (written in place) and hashes those under their own keys,
which must equal the ones of the steps that leave the caches alone.
Fails unless the four runs give the same digest for every key they
share.  Prints one line per model and writes every digest to ``--out``
(JSON).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("llama3_8b", "granite_moe_3b_a800m", "xlstm_350m",
         "recurrentgemma_2b")
LAYERS = {"llama3_8b": 4, "granite_moe_3b_a800m": 4, "xlstm_350m": 4,
          "recurrentgemma_2b": 6}
PROMPT, STEPS = 512, 8

_CHILD = r"""
import dataclasses, hashlib, inspect, json, sys
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from repro_torch.configs import get_config
from repro_torch.models import build_model
import repro_torch.models as M
assert M.__file__.startswith(sys.argv[1]), M.__file__
spec = json.loads(sys.argv[2])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)


def digest(ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def cache_digest(caches):
    return digest([c[k] for c in caches for k in sorted(c)])


out = {}
for arch in spec["archs"]:
    cfg = dataclasses.replace(get_config(arch),
                              n_layers=spec["layers"][arch])
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(1)
    B, S = 2, spec["prompt"]
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=g, device=dev,
                           dtype=torch.int32)
    donate = "donate" in inspect.signature(model.decode_step).parameters
    with torch.no_grad():
        logits, caches = model.prefill(params, {"tokens": tokens},
                                       S + spec["steps"])
        out[f"{arch} prefill logits"] = digest([logits])
        out[f"{arch} prefill caches"] = cache_digest(caches)
        runs = [("", [{k: v.clone() for k, v in c.items()}
                      for c in caches], {})]
        if donate:
            runs.append((" donated", caches, {"donate": True}))
        for tag, cs, kw in runs:
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            for i in range(spec["steps"]):
                pos = torch.full((B,), S + i, dtype=torch.int32, device=dev)
                step_logits, cs = model.decode_step(params, cs, tok, pos,
                                                    **kw)
                out[f"{arch} decode{tag} step {i} logits"] = digest(
                    [step_logits])
                tok = torch.argmax(step_logits, dim=-1).to(torch.int32)
            out[f"{arch} decode{tag} caches"] = cache_digest(cs)
    del params, caches, runs
    torch.cuda.empty_cache()
print(json.dumps({"device": torch.cuda.get_device_name(0), "digests": out}))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", type=Path, required=True)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "ab_decode_bits.json")
    args = ap.parse_args()
    spec = json.dumps({"archs": ARCHS, "layers": LAYERS, "prompt": PROMPT,
                       "steps": STEPS})
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
    shared = [k for k in runs[0][1]["digests"]
              if all(k in r["digests"] for _, r in runs)]
    differ = sorted(k for k in shared if len({r["digests"][k]
                                              for _, r in runs}) > 1)
    # a donated run's digests against the same tree's undonated ones
    for side, r in runs:
        for k, v in r["digests"].items():
            if " donated" in k and r["digests"][k.replace(" donated", "")] != v:
                differ.append(f"{side}: {k}")
    for arch in ARCHS:
        keys = [k for k in shared if k.startswith(arch + " ")]
        bad = [k for k in differ if arch in k]
        donated = sum(" donated" in k for _, r in runs
                      for k in r["digests"] if k.startswith(arch + " "))
        print(f"ab_decode_bits {arch}: {len(keys)} digests in all four runs,"
              f" {len(keys) - len([k for k in keys if k in differ])} the same"
              f"; {donated} donated-step digests, each the undonated one's"
              f"{'' if not bad else '; differ: ' + str(bad)}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"device": runs[0][1]["device"],
                                    "runs": [[s, r["digests"]]
                                             for s, r in runs],
                                    "differ": differ}, indent=1))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
