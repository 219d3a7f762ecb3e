"""Profile the decode steps of some of ``chip_smoke.py``'s qwen3-moe serving
runs in one checkout of the repo, so that two commits can be compared on one
card back to back: run it once per checkout, in turns (parent, change,
change, parent), each in its own process.

    python3 tools/decode_steps.py                         # this checkout
    python3 tools/decode_steps.py --tree DIR              # another checkout
    python3 tools/decode_steps.py --runs compressed:int8:static,dense:int8:static

Each run is ``chip_smoke.serve_layout`` of the checkout at hand (its own
kernels, built from its sources into its own ``build/``), on the spgemm
expert path: serving the seeded trace with every check the smoke test makes,
then one decode step under torch.profiler.  One JSON line a run: the
checkout, the run's tag, the step's device busy ms, idle share and
launches, and its top kernels.  It needs a card and exits non-zero without
one.
"""

import argparse
import json
import os
import sys

import torch


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), help="root of the checkout whose chip_smoke.py and kernels run")
    ap.add_argument("--runs", default="compressed:int8:static,dense:int8:static",
                    help="comma-separated layout:qdtype[:static] of chip_smoke.MOE_RUNS' "
                         "spgemm runs (qdtype none for bf16)")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    import chip_smoke

    if not torch.cuda.is_available():
        chip_smoke.fail("no card: the decode steps run CUDA kernels")
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    card = chip_smoke.card()
    wanted = []
    for run in args.runs.split(","):
        layout, qdtype, *static = run.split(":")
        wanted.append((layout, None if qdtype == "none" else qdtype, static == ["static"]))
    moe_cfg = get_config(chip_smoke.MOE_ARCH)
    for path, layout, sparsity, qdtype, static in chip_smoke.MOE_RUNS:
        if path != "spgemm" or (layout, qdtype, static) not in wanted:
            continue
        res, _ = chip_smoke.serve_layout(moe_cfg, layout, sparsity, qdtype, static,
                                         chip_smoke.MOE_DEPTH, path)
        prof = res["decode_profile"]
        chip_smoke.log(json.dumps({
            "tree": tree, "run": res["layout"], "device_busy_ms": prof["device_busy_ms"],
            "device_idle_share": prof["device_idle_share"],
            "launches_per_step": prof["launches_per_step"], "top_kernels": prof["top_kernels"],
            "card": card}))
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
