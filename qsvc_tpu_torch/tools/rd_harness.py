"""RD evidence harness: MCTF against OpenJPEG-intra at a matched rate.

Port of the JAX package's ``tools/rd_harness.py`` (which wrote
``RD_r04.json``), at its configuration (176x144, TRLs 4, GOPs 2, block
16, search 4, SRLs 4, encode slope 42000, 9 quality layers, update 1/4),
its four sequences and its slopes, with both coders: for each sequence,
coder and slope the MCTF stream is truncated (no re-encode,
``scal/rd.rd_curve``) and decoded on ``device``, and OpenJPEG codes the
same frames intra at the same byte budget (``scal/anchor.match_rate``).
On temporally redundant content the MCTF curve must sit above the intra
one; on the static-noise fixture ("moving_static_noise": the noise floor
does not follow the motion) intra is expected to win, and the artifact
records it.  The QCIF size is the JAX harness's own, so its points
compare one for one with ``RD_r04.json``.

Writes the JAX harness's JSON schema (``config``, ``anchor``, ``device``,
``sequences``, ``summary``), numbers unrounded; ``device`` is the card's
name and power limit as ``nvidia-smi`` reads them, or ``"cpu"``.

Run from the root of a checkout (``--device cpu`` runs the kernels'
plain versions on the host; the default is the card, with no fallback):

    python3 -m qsvc_tpu_torch.tools.rd_harness [--out F] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import api
from ..config import CodecConfig
from ..io import Video, synthetic_video
from ..scal import anchor, rd as rdmod
from .bench import device_name

SLOPES = [44000.0, 44750.0, 45250.0, 45750.0]
#: the configuration of the JAX harness (``tools/rd_harness.py:81-84``)
CONFIG = dict(pixels_in_x=176, pixels_in_y=144, TRLs=4, GOPs=2,
              block_size=16, search_range=4, SRLs=4,
              quantization_texture=42000, nLayers=9, update_factor=0.25)
#: the sequence run with sub-pixel ME (accuracy 1); the others whole-pixel
SUBPIXEL = {"translate_frac": 1}
#: the pair whose mid-rate mq points make the summary
TRANSLATE = ("translate_int", "translate_frac")


def sequences(cfg: CodecConfig) -> dict:
    """The JAX harness's four sequences at ``cfg``'s size, by name."""
    n, h, w = cfg.pictures, cfg.pixels_in_y, cfg.pixels_in_x
    return {
        # the codec's home turf: everything (noise included) translates
        "translate_int": synthetic_video(n, h, w, seed=5, kind="translate",
                                         velocity=(1.0, 2.0)),
        # fractional motion: needs sub-pixel ME to track
        "translate_frac": synthetic_video(n, h, w, seed=7, kind="translate",
                                          velocity=(1.5, 2.5)),
        # adversarial: static noise floor under moving content (MC cannot
        # track the noise; intra is expected to win here)
        "moving_static_noise": synthetic_video(n, h, w, seed=5,
                                               kind="moving"),
        # trivially smooth
        "gradient": synthetic_video(n, h, w, seed=5, kind="gradient"),
    }


def mctf_points(vid: Video, cfg: CodecConfig, coder: str, slopes,
                device="cuda") -> tuple:
    """Encode ``vid`` once with ``coder`` on ``device`` and trace its RD
    curve at ``slopes``: ``(encode seconds, [RDPoint])``."""
    t0 = time.perf_counter()
    vs = api.compress(vid, cfg.replace(texture_coder=coder),
                      reversible=False, device=device)
    enc_s = time.perf_counter() - t0
    return enc_s, rdmod.rd_curve(vs, vid, slopes, device=device)


def curve_for(vid: Video, cfg: CodecConfig, coder: str, slopes,
              device="cuda") -> dict:
    """The JAX harness's curve of one sequence and coder: each MCTF point
    beside OpenJPEG-intra at the same byte budget."""
    enc_s, pts = mctf_points(vid, cfg, coder, slopes, device=device)
    raw = np.asarray(vid.y).size * 3 // 2
    out = []
    for p in pts:
        n_opj, dec_opj, _ = anchor.match_rate(vid, p.bytes)
        opj_psnr = anchor.psnr_y(vid, dec_opj)
        out.append({
            "slope": p.quantization,
            "mctf_bytes": p.bytes,
            "mctf_bpp": p.bytes * 8 / raw,
            "mctf_psnr_y": p.psnr_y,
            "opj_bytes": n_opj,
            "opj_bpp": n_opj * 8 / raw,
            "opj_psnr_y": opj_psnr,
            "advantage_db": p.psnr_y - opj_psnr,
        })
    return {"coder": coder, "encode_seconds": enc_s, "points": out}


def midrate_advantages(curve: dict) -> list:
    """The advantages (dB) of a curve's two middle points."""
    return [p["advantage_db"] for p in curve["points"][1:3]]


def rd_harness(cfg: CodecConfig, videos: dict, device="cuda") -> dict:
    """Both coders' curves of each of ``videos`` ({name: Video}, see
    :func:`sequences`) at ``cfg`` on ``device``, in the JAX harness's
    JSON schema; prints one line per point."""
    result = {
        "config": {
            "geometry": f"{cfg.pixels_in_x}x{cfg.pixels_in_y}",
            "TRLs": cfg.TRLs, "GOPs": cfg.GOPs, "frames": cfg.pictures,
            "SRLs": cfg.SRLs, "block_size": cfg.block_size,
            "search_range": cfg.search_range, "nLayers": cfg.nLayers,
            "encode_slope": cfg.quantization_texture,
        },
        "anchor": "OpenJPEG (Pillow) lossy 9/7 intra, matched byte budget",
        "device": device_name(device),
        "sequences": {},
    }
    for name, vid in videos.items():
        sp = SUBPIXEL.get(name, 0)
        c = cfg.replace(subpixel_accuracy=sp)
        entry = {}
        for coder in ("bp", "mq"):
            entry[coder] = curve_for(vid, c, coder, SLOPES, device=device)
            for p in entry[coder]["points"]:
                print(f"{name:20s} {coder} slope {p['slope']:.0f} "
                      f"mctf {p['mctf_bpp']:.4f}bpp {p['mctf_psnr_y']:.2f}dB"
                      f" | opj {p['opj_bpp']:.4f}bpp "
                      f"{p['opj_psnr_y']:.2f}dB  adv "
                      f"{p['advantage_db']:+.2f}dB", flush=True)
        entry["subpixel_accuracy"] = sp
        result["sequences"][name] = entry

    # headline: mean mid-rate advantage on the temporally redundant pair
    adv = [a for s in TRANSLATE
           for a in midrate_advantages(result["sequences"][s]["mq"])]
    result["summary"] = {
        "mean_midrate_advantage_db_mq_translate": float(np.mean(adv)),
    }
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="RD_torch.json")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("rd_harness: no CUDA device", file=sys.stderr)
        return 1
    if not anchor.available():
        print("OpenJPEG (Pillow jpg_2000) unavailable", file=sys.stderr)
        return 1
    cfg = CodecConfig(**CONFIG)
    result = rd_harness(cfg, sequences(cfg), device=args.device)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print("wrote", args.out, "summary", result["summary"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
