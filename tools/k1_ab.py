"""Time kernel K1 (the spiral-SAD refinement) of the port in a checkout
at each of its 14 calls in one flagship GOP, on one CUDA card.

    python3 tools/k1_ab.py [ROOT] [--wide]

Imports ``qsvc_tpu_torch`` from the checkout at ROOT (default: this one)
and runs ``chip_smoke.k1_calls`` of this checkout with its K1: the same
inputs from the same seed, each call exact against the plain version,
device times beside the bound.  Run in turns on two checkouts on one
card (parent, change, change, parent), it compares two versions of the
kernel.  ``cuda_me.refine`` returned the (P, 4, By, Bx)
deltas before the redesign and the refined vectors since; both are
taken.  ``--wide`` adds ``chip_smoke.k1_wide_calls`` (the sub-pixel
calls, a block of 1024, borders 1-4), for a checkout whose K1 takes
them.
"""

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    args = [a for a in sys.argv[1:] if a != "--wide"]
    root = os.path.abspath(args[0] if args else HERE)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("k1_ab: no CUDA device", file=sys.stderr)
        return 1
    # this checkout's chip_smoke.py, whatever ROOT holds
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from qsvc_tpu_torch.ops import cuda_me

    def refine(pr, pv, nxt, mv, bs, ny, nx, sr, border):
        out = cuda_me.refine(pr, pv, nxt, mv, bs, border, ny, nx, sr)
        return out if out.shape == mv.shape else mv + out.view(mv.shape)
    print(f"K1 of {root}", flush=True)
    dev = torch.device("cuda")
    rows = chip_smoke.k1_calls(dev, refine)
    if "--wide" in sys.argv[1:]:
        rows += chip_smoke.k1_wide_calls(dev, refine)
    bad = [r["label"] for r in rows if r["max_abs_err"] != 0]
    if bad:
        print(f"k1_ab: K1 differs from the plain version at {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
