"""What decides ``correct`` for an entry that answers with streams: the
program's streams against the plain reference's.

After the window the reference (:mod:`.reference`) encodes every item the
run was fed, on the same card, and decodes the texture of its own stream
and of each distinct stream the program answered for that item.  What is
integer in the codec is compared exactly; what follows the float 9/7
transform is compared by what it costs and what it loses, so that a
program that orders its float arithmetic otherwise still passes while
one that codes the texture worse does not.  The numbers, each with its
limit:

* ``layout_differing`` (exact, 0): answers whose stream does not parse,
  or differs from the reference's anywhere but in the texture blocks'
  coded passes: the headers, every block's place and band, the frame
  types and the motion sections (the motion search, its prediction and
  update steps and the motion coder are integer);
* ``answers_missing`` (exact, 0): answers whose stream never came, or
  whose item the reference was not given;
* ``rd_cost_excess_pct``: the worst answer's texture R-D cost over the
  reference's, less 1, in %.  The cost is the one the encoder's R-D
  truncation minimizes, frame by frame: the squared error of the decoded
  code-blocks against the reference's quantized ones, each weighted as
  the encoder weighs it, plus the frame's slope threshold times its
  texture bytes.  It covers the MCTF's temporal subbands through the DWT,
  quantization, the R-D truncation and the coded bits; a stream that
  rounds its float arithmetic otherwise moves a pass at the margin of
  the truncation, which leaves the cost as it was to first order, while
  one that codes worse pays in error or in bytes.

``benchmark.control`` gives the readings the two tolerances were set
from.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List, Tuple

#: every compared number's limit.  The R-D cost's: the program's runs
#: and the float64 variant read 0.0 in both cells; the bfloat16 control
#: 0.0159 (one card) and 0.0068 (four); PERF.md gives the readings
LIMITS = {"layout_differing": 0, "answers_missing": 0,
          "rd_cost_excess_pct": 0.004}


def passed(compared: Dict[str, dict]) -> bool:
    return all(v["value"] is not None and v["value"] <= v["limit"]
               for v in compared.values())


def unmeasured() -> Dict[str, dict]:
    """The numbers of a run that never reached its comparison."""
    return {k: {"value": None, "limit": v} for k, v in LIMITS.items()}


def rd_cost(frames: List[List[tuple]], truth, device) -> float:
    """The texture R-D cost of a parsed stream's ``frames`` against
    ``truth`` (:class:`.reference.encode.Truth`): per frame, the weighted
    squared error of its decoded code-blocks against the quantized ones,
    plus its threshold times its coded bytes; infinite where the two do
    not have the same blocks."""
    import torch

    from .reference.codec import bp
    if len(frames) != len(truth.tiles):
        return float("inf")
    coded, where = [], []
    for f, blocks in enumerate(frames):
        if len(blocks) != truth.tiles[f].shape[0]:
            return float("inf")
        for t, b in enumerate(blocks):
            if b[1]:
                coded.append(b)
                where.append((f, t))
    cb = truth.tiles[0].shape[-1]
    rec = bp.decode_blocks(coded, cb, device)
    total = 0.0
    k = 0
    for f, (tiles, w) in enumerate(zip(truth.tiles, truth.weights)):
        err = tiles.to(torch.int64)
        n = 0
        while k + n < len(where) and where[k + n][0] == f:
            n += 1
        if n:
            pos = torch.tensor([t for _f, t in where[k:k + n]],
                               device=err.device)
            err = err.index_put((pos,), err[pos] - rec[k:k + n])
            k += n
        sse = (err * err).sum(dim=(1, 2)).to(torch.float64)
        total += float((sse * w.to(torch.float64)).sum())
        total += truth.thresholds[f] * sum(len(b[2]) for b in frames[f])
    return total


def _excess_pct(value: float, reference: float) -> float:
    if reference > 0:
        return 100.0 * (value / reference - 1.0)
    return 0.0 if value == reference else float("inf")


def compare_streams(answers, program: Dict[int, bytes], pieces: dict,
                    encode, device) -> Tuple[Dict[str, dict], int]:
    """``answers`` (records.Answer), ``program`` their streams' bytes by
    answer index, ``pieces`` each item's input; ``encode(piece)`` is the
    reference's ``(stream, Truth)`` of a piece.  Returns ``{name:
    {"value", "limit"}}`` and how many answers failed."""
    from .reference.codec import reader
    layout = missing = failed = 0
    worst = -math.inf
    by_item: Dict[int, List[int]] = {}
    for i, a in enumerate(answers):
        if i not in program or a.item not in pieces:
            missing += 1
        else:
            by_item.setdefault(a.item, []).append(i)
    for item, idx in by_item.items():
        ref, truth = encode(pieces[item])
        parsed_ref = reader.parse(ref)
        # the same bytes decode alike: the reference's own stream is
        # decoded only where an answer differs from it
        seen: Dict[bytes, tuple] = {ref: (False, 0.0)}
        j_ref = None
        for i in idx:
            data = program[i]
            if data not in seen:
                if j_ref is None:
                    j_ref = rd_cost(parsed_ref.frames, truth, device)
                try:
                    got = reader.parse(data)
                except (ValueError, IndexError):
                    seen[data] = (True, float("inf"))
                else:
                    seen[data] = (got.layout != parsed_ref.layout,
                                  _excess_pct(rd_cost(got.frames, truth,
                                                      device), j_ref))
            bad_layout, excess = seen[data]
            layout += bad_layout
            worst = max(worst, excess)
            failed += (bad_layout
                       or not excess <= LIMITS["rd_cost_excess_pct"])
        del truth
    values = {"layout_differing": layout, "answers_missing": missing,
              "rd_cost_excess_pct": worst}
    # a stream that decodes to no number, or no stream compared, reads
    # None, which fails
    return ({k: {"value": values[k] if math.isfinite(values[k]) else None,
                 "limit": LIMITS[k]} for k in LIMITS}, missing + failed)


def judge_streams(ctx, pieces: dict, answers, outputs: Dict[int, bytes]
                  ) -> Tuple[Dict[str, dict], int]:
    """The comparison of an entry that answers with streams, on the
    entry's device: ``pieces`` each item's (y, u, v) frames."""
    from .reference import encode as reference
    from .reference.config import CodecConfig
    rcfg = CodecConfig(**ctx.codec)

    def encode(piece):
        return reference.encode(*piece, rcfg, ctx.device, truth=True)
    return compare_streams(answers, outputs, pieces, encode, ctx.device)


def print_compared(compared: Dict[str, dict]) -> None:
    """Each compared number beside its limit, one line each, on standard
    error."""
    for name, v in compared.items():
        print(f"compared {name}: {v['value']} (limit {v['limit']})",
              file=sys.stderr, flush=True)
