"""Readings that the correctness limits are set from, at a cell's own size.

    python3 h100bench/control.py --workload <cell> --seeds 1 2 3 \
        --variants program control half_batch no_exchange

For each seed, every variant's compared numbers (``h100bench/check.py``)
against the reference on that seed's weights and batches:

* ``program``: the port's first three steps, as a run of the cell takes
  them (the lower readings);
* ``control``: the reference in the program's place, its products in the
  nearest precision below the configuration's (TF32 for float32, FP8 e4m3
  for bfloat16);
* ``half_batch``, ``no_exchange``: the reference in the program's place
  with that fault planted (``h100bench/reference/pdasgd.py``).

A step that returns its state unchanged reads ``update_gap`` = 1 by
definition and needs no run. One JSON line a seed and variant; the
benchmark's own runs never run this.

``--ulps`` adds the look at what ``update_gap`` is made of: for every
leaf, in units in the last place of the configuration's dtype, the shares
of elements that the program's three steps and the reference's moved by
0, 1 and more ulps from the initial weights, and the shares in which the
program's parameters equal the reference's or lie 1 ulp from them, with
the largest distance (``ulp_look``).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
VARIANTS = ("program", "control", "half_batch", "no_exchange")


def readings(spec: dict, seed: int, variants, device: str,
             ulps: bool = False) -> dict:
    """{variant: {"numbers": the compared numbers, "worst_leaves"}} of one
    seed; with ``ulps``, the program's entry also has ``ulps``
    (:func:`ulp_look`)."""
    import torch

    from h100bench import check, inputs, program
    from h100bench.reference import pdasgd
    from h100bench.reference.precision import CONTROL
    from h100bench.run import CHECK_STEPS

    cfg, job = spec["config"], spec["traffic"]
    dtype_name = cfg["model"]["dtype"]
    dtype = getattr(torch, dtype_name)
    got = {}
    finals = ({"program": {}, "reference": {}}
              if ulps and "program" in variants else None)
    model, backend = program.build(cfg, job, device)
    shapes = program.param_shapes(model)
    batches = inputs.make_batches(job, cfg["model"]["vocab_size"], seed,
                                  device)
    if "program" in variants:
        weights = inputs.make_weights(shapes, dtype, cfg["init"], seed,
                                      device)
        box = {"state": backend.init(seed, inputs.nest(weights))}
        got["program"] = program.first_steps(
            backend, box, batches, weights, CHECK_STEPS, job["update_delay"],
            keep=finals and finals["program"])
        program.close(backend)
        del box, weights
    del backend, model
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    weights = inputs.make_weights(shapes, dtype, cfg["init"], seed, device)

    def ref(**kw):
        return pdasgd.run(weights, batches, cfg["model"], job, CHECK_STEPS,
                          **kw)

    want = ref(keep=finals and finals["reference"])
    for v in variants:
        if v == "control":
            got[v] = ref(precision=CONTROL[dtype_name])
        elif v in ("half_batch", "no_exchange"):
            got[v] = ref(fault=v)
    out = {v: {"numbers": check.compare(got[v], want),
               "worst_leaves": worst_leaves(got[v], want)}
           for v in variants}
    if finals:
        out["program"]["ulps"] = ulp_look(finals["program"],
                                          finals["reference"], weights)
    return out


def ulp_distance(a, b):
    """|a − b| in units in the last place of their (equal) float dtype:
    the distance of their bit patterns on the line of ordered floats."""
    import torch
    bits = {2: torch.int16, 4: torch.int32}[a.element_size()]
    mag = (1 << (8 * a.element_size() - 1)) - 1

    def ordered(v):
        i = v.contiguous().view(bits).to(torch.int64)
        return torch.where(i < 0, -(i & mag), i)
    return (ordered(a) - ordered(b)).abs()


def ulp_look(prog: dict, ref: dict, init: dict) -> dict:
    """{leaf: {"moved_0_1_more": the program's shares of elements moved by
    0, 1 and more ulps from ``init``, "ref_moved_0_1_more": the
    reference's, "vs_ref_0_1_max": the shares in which the program equals
    the reference and lies 1 ulp from it, and the largest distance}}, and
    ``"all"``: the last over every leaf. Each leaf is (workers, ...)."""
    def shares(d):
        n = d.numel()
        return [float((d == 0).sum()) / n, float((d == 1).sum()) / n,
                float((d > 1).sum()) / n]

    out, n_all, eq_all, one_all, top = {}, 0, 0, 0, 0
    for p, x0 in init.items():
        dev = x0.device
        got, want = prog[p].to(dev, x0.dtype), ref[p].to(dev, x0.dtype)
        start = x0.expand_as(got)
        dp, dr = ulp_distance(got, start), ulp_distance(want, start)
        dv = ulp_distance(got, want)
        sp, sr, sv = shares(dp), shares(dr), shares(dv)
        worst = int(dv.max())
        out[p] = {"moved_0_1_more": sp, "ref_moved_0_1_more": sr,
                  "vs_ref_0_1_max": sv[:2] + [worst]}
        n_all += dv.numel()
        eq_all += int((dv == 0).sum())
        one_all += int((dv == 1).sum())
        top = max(top, worst)
    out["all"] = {"vs_ref_0_1_max": [eq_all / n_all, one_all / n_all, top]}
    return out


def worst_leaves(got: dict, want: dict, top: int = 3) -> dict:
    """The leaves with the largest gaps, for the look at what a number's
    spread comes from."""
    from h100bench import check
    grad = check.leaf_gaps(got["grad_norms"], want["grad_norms"])
    upd = check.leaf_gaps(got["update_norms"], want["update_norms"],
                          check.moved(want))
    return {name: sorted(g.items(), key=lambda kv: -kv[1])[:top]
            for name, g in (("grad", grad), ("update", upd))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=VARIANTS)
    ap.add_argument("--ulps", action="store_true",
                    help="add the program's ulp look (ulp_look)")
    args = ap.parse_args(argv)
    from h100bench.run import environment
    environment()
    import torch

    from h100bench.spec import load_cell

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    spec = load_cell(args.workload)
    for seed in args.seeds:
        for v, r in readings(spec, seed, args.variants, "cuda",
                             args.ulps).items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "variant": v, **r["numbers"],
                              "worst_leaves": r["worst_leaves"],
                              **({"ulps": r["ulps"]} if "ulps" in r
                                 else {})}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
