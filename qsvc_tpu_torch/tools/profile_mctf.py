"""Sub-stage attribution of the MCTF analysis at the flagship.

Port of the JAX package's ``tools/profile_mctf.py``: one GOP of the
flagship (``bench.flagship()``), the whole ``analyze_jit`` first, then
temporal level 1 (8 pairs) step by step with the functions that
``transform._analyze_level`` runs, each timed alone (after a warm-up
call, the median of 5 calls, each ended by a synchronise; the JAX tool
read the last of two):

- ME: ``me.estimate_sequence``, then its pieces, the 5/3 LL pyramid
  (``dwt2d.downsample2``) and one ``refine_level`` at full resolution
  (K1, ``csrc/me_refine.cu``);
- ``predict.refs_to_444_batch`` of the evens;
- the prediction, ``predict.predict_frames_subpixel_evens`` (K2,
  ``mc_predict_kernel``), and ``decorrelate_from_preds`` with its pieces,
  chroma downsampling and ``histogram_entropy`` x3;
- ``update.residues_to_444``;
- the update, one direction (``update.update_fields_batch``, K4, the
  sharded MCTF's kernel) and both (``update_fields_batch2``, K3), then
  its application to the evens.

With ``--subpel a`` the GOP is analysed at sub-pixel accuracy ``a``: the
ME's interpolation (``dwt2d.upsample2`` of the lumas) and its sub-pixel
refinements (K1), and the prediction's interpolation (``upsample2`` of
the 4:4:4 evens), its K2 call at ``block << a`` and its decimation
(``downsample2``) are then timed apart.  The steps' outputs are level
1's: its high bands, motion field and frame types, and the low band
the next level starts from.

Run from the root of a checkout (one card; no CPU fallback):

    python3 -m qsvc_tpu_torch.tools.profile_mctf [--subpel A] [--out F]
"""

from __future__ import annotations

import argparse
import math
import sys

import torch

from .. import api
from ..config import CodecConfig
from ..io import Video
from ..mctf import me, predict, transform, update
from ..ops import dwt2d
from ..ops.entropy import histogram_entropy_rows
from . import bench
from .profile import median_seconds, needs_card, write_json


def profile_mctf(cfg: CodecConfig, video: Video, device="cuda",
                 reps: int = 5) -> tuple:
    """The sub-stages of the MCTF analysis of ``video``'s first GOP at
    ``cfg`` (its ``subpixel_accuracy`` included).  Returns (row, level):
    the JSON row of (label, seconds) rows and level 1's outputs,
    ``{"level": transform.LevelData, "low": (y, u, v)}``."""
    gop_cfg = cfg.replace(GOPs=1)
    gop = api._upload(video[0:cfg.gop_size + 1], device)
    rows = []

    def timed(label, fn, *args):
        seconds, out = median_seconds(lambda: fn(*args), reps, device)
        rows.append((label, seconds))
        return out

    timed("analyze_jit (all levels)", transform.analyze_jit, gop.y, gop.u,
          gop.v, gop_cfg)
    lp = gop_cfg.level_schedule()[0]
    bs, sr, a = lp.block_size, lp.search_range, gop_cfg.subpixel_accuracy
    border = gop_cfg.border_size
    y, u, v = (p.to(torch.int16) for p in (gop.y, gop.u, gop.v))
    ey, eu, ev = (p[0::2].contiguous() for p in (y, u, v))
    oy, ou, ov = (p[1::2].contiguous() for p in (y, u, v))
    P, H, W = oy.shape

    mv = timed(f"ME level 1 ({P} pairs)", me.estimate_sequence, ey, oy, bs,
               sr, border, a)
    depth = max(int(round(math.log2(sr))) - 1, 0)

    def pyramid(*stacks):
        out = []
        for s in stacks:
            for _ in range(depth):
                s = dwt2d.downsample2(s).contiguous()
            out.append(s)
        return out
    timed(f"  ME pyramid (downsample2 x{depth}, evens and odds)", pyramid,
          ey, oy)
    mv_whole = (me.estimate_sequence(ey, oy, bs, sr, border) if a
                else mv)
    timed("  ME refine_level at full resolution (K1)",
          me._refine_level_batch, oy, ey[:-1], ey[1:], mv_whole, bs, border,
          H, W, sr)
    if a:
        up_e, up_o, sub = ey, oy, mv_whole
        cap = sr << a
        for s in range(1, a + 1):
            up_e, up_o = timed(
                f"  ME sub-pixel step {s}: upsample2 of evens and odds",
                lambda e, o: tuple(dwt2d.interpolate([e, o], 1)), up_e,
                up_o)
            sub = timed(f"  ME sub-pixel step {s}: refine (K1, block "
                        f"{bs << s})", me._refine_level_batch, up_o,
                        up_e[:-1], up_e[1:], (sub * 2).clamp(-cap, cap),
                        bs << s, border >> s, H << s, W << s, cap)
        del up_e, up_o, sub

    e444 = timed(f"refs_to_444 ({P + 1} evens)", predict.refs_to_444_batch,
                 (ey, eu, ev))
    ola = gop_cfg.block_overlaping
    preds = timed(f"predict ({P} pairs, K2)",
                  predict.predict_frames_subpixel_evens, e444, mv, bs, sr,
                  a, ola)
    if a:
        up = timed(f"  interpolate: upsample2 x{a} of the 4:4:4 evens",
                   predict._interpolate, e444, a)
        pred_up = timed(f"  K2 at block {bs << a}",
                        predict.predict_frames_batch, up[:-1], up[1:], mv,
                        bs << a, sr << a, ola << a)
        del up
        timed(f"  decimate: downsample2 x{a}", predict._decimate, pred_up, a)
        del pred_up
    else:
        timed("  predict_frames_batch only (K2)",
              predict.predict_frames_batch, e444[:-1], e444[1:], mv, bs, sr,
              ola)
    dec = timed(f"decorrelate_from_preds ({P} pairs)",
                predict.decorrelate_from_preds, (oy, ou, ov), preds, mv,
                gop_cfg.always_B)
    timed("  downsample_chroma x2",
          lambda p: (predict.downsample_chroma(p[:, 1]),
                     predict.downsample_chroma(p[:, 2])), preds)
    timed("  histogram_entropy x3",
          lambda o: (histogram_entropy_rows(o), histogram_entropy_rows(o + 1),
                     histogram_entropy_rows(o + 2)), oy)
    del preds

    level = transform.LevelData(dec.high_y, dec.high_u, dec.high_v,
                                dec.mv_out, dec.is_B)
    if gop_cfg.update_factor == 0.0:
        return _row(device, gop, gop_cfg, rows), {"level": level,
                                                  "low": (ey, eu, ev)}
    res = timed("residue_to_444", update.residues_to_444,
                (dec.high_y, dec.high_u, dec.high_v), dec.is_B)
    mvu = dec.mv_out >> a
    uf = gop_cfg.update_factor
    timed("update, one direction (K4)", update.update_fields_batch, res,
          mvu[:, 0, 0], mvu[:, 0, 1], bs, uf, sr)
    upd_prev, upd_next = timed("update, both directions (K3)",
                               update.update_fields_batch2, res, mvu, bs,
                               uf, sr)

    def apply(evens, prev, nxt):
        out = evens.clone()
        out[1:] = update.apply_update(out[1:], nxt, 1)
        out[:-1] = update.apply_update(out[:-1], prev, 1)
        return (out[:, 0], predict.downsample_chroma(out[:, 1]),
                predict.downsample_chroma(out[:, 2]))
    low = timed("apply the update, back to 4:2:0", apply, e444, upd_prev,
                upd_next)
    return _row(device, gop, gop_cfg, rows), {"level": level, "low": low}


def _row(device, gop, cfg, rows) -> dict:
    return {"device": bench.device_name(device), "frames": gop.frames,
            "subpixel_accuracy": cfg.subpixel_accuracy,
            "rows": [{"label": k, "seconds": s} for k, s in rows]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--subpel", type=int, default=0,
                    help="sub-pixel accuracy of the analysis (default 0)")
    ap.add_argument("--out", default="", help="also write the row here")
    args = ap.parse_args(argv)
    if not needs_card("profile_mctf"):
        return 1
    cfg, video = bench.flagship()
    row, _ = profile_mctf(cfg.replace(subpixel_accuracy=args.subpel), video,
                          device="cuda")
    print(f"profile_mctf [{row['device']}]: one GOP, {row['frames']} frames,"
          f" sub-pixel accuracy {row['subpixel_accuracy']}", flush=True)
    for r in row["rows"]:
        print(f"{r['label']:56s} {r['seconds']:9.6f} s", flush=True)
    write_json(args.out, row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
