"""The port's staged flagship encode and decode in a checkout, with and
without what that checkout runs them through, on one CUDA card.

    python3 tools/graphs_ab.py [ROOT]

Imports ``qsvc_tpu_torch`` from the checkout at ROOT (default: this one)
and runs this checkout's ``chip_smoke._staged_run`` on it: 4 GOPs of the
flagship (1920x1088, TRLs 5, 9/7 at slope 45000) staged on the card, at
whole-pixel accuracy (phase 4) and at sub-pixel accuracy 2 (phase 6):
encode and decode fps, bpp, PSNR, kernel launches and peak device
memory.  Then one encode and one decode of the 4 whole-pixel GOPs under
``torch.profiler`` (``qsvc_tpu_torch.tools.profile.window``): wall,
device busy share, host launches (CUDA runtime launch calls) and device
operations.  ROOT's package must have ``tools/profile.py`` and
``tools.bench.staged_gops``.
Run in turns on two checkouts on one card (parent, change, change,
parent), it compares them; the parent is unpacked with ``git archive``
into a gitignored directory.
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
        print("graphs_ab: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from qsvc_tpu_torch import api
    from qsvc_tpu_torch.codec.codestream import VideoStream
    from qsvc_tpu_torch.io import synthetic_video
    from qsvc_tpu_torch.tools.bench import staged_gops
    from qsvc_tpu_torch.tools.profile import window

    print(f"checkout {root}", flush=True)
    dev = torch.device("cuda")
    chip_smoke._staged_run(dev, chip_smoke._flagship_cfg(),
                           "flagship 1920x1088 GOP16", "flagship")
    chip_smoke._staged_run(dev, chip_smoke._flagship_cfg(subpixel_accuracy=2),
                           "sub-pixel flagship a=2", "a=2")
    cfg = chip_smoke._flagship_cfg()
    gop_cfg = cfg.replace(GOPs=1)
    vid = synthetic_video(cfg.pictures, cfg.pixels_in_y, cfg.pixels_in_x,
                          seed=0)
    staged = staged_gops(vid, cfg, dev)
    streams = []

    def encode():
        streams[:] = api.compress_chunks(staged, gop_cfg, reversible=False,
                                         device=dev)
    encode()
    enc = window(encode, smi=False)
    parsed = [VideoStream.from_bytes(s.to_bytes()) for s in streams]

    def decode():
        for p in parsed:
            api.expand(p, to_host=False, device=dev)
    decode()
    dec = window(decode, smi=False)
    for name, w in (("encode", enc), ("decode", dec)):
        print(f"profiled 4-GOP {name}: wall {w['wall_s']:.4f} s, device "
              f"busy {w['busy_s']:.4f} s ({w['busy_share']:.1%}), host "
              f"launches {w['host_launches']}, device ops "
              f"{w['device_ops']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
