"""Time kernel K1 (the spiral-SAD refinement) of the port in a checkout
at each of its 14 calls in one flagship GOP, on one CUDA card.

    python3 tools/k1_ab.py [ROOT]

Imports ``qsvc_tpu_torch`` from the checkout at ROOT (default: this one)
and runs ``chip_smoke.k1_calls`` of this checkout with its K1: the same
inputs from the same seed, each call exact against the plain version,
device times beside the bound.  Run in turns on two checkouts on one
card (parent, change, change, parent), it compares two versions of the
kernel.  ``cuda_me.refine`` returned the (P, 4, By, Bx)
deltas before the redesign and the refined vectors since; both are
taken.
"""

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
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

    def refine(pr, pv, nxt, mv, bs, ny, nx, sr):
        out = cuda_me.refine(pr, pv, nxt, mv, bs, 0, ny, nx, sr)
        return out if out.shape == mv.shape else mv + out.view(mv.shape)
    print(f"K1 of {root}", flush=True)
    rows = chip_smoke.k1_calls(torch.device("cuda"), refine)
    bad = [r["label"] for r in rows if r["max_abs_err"] != 0]
    if bad:
        print(f"k1_ab: K1 differs from the plain version at {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
