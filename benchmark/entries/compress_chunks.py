"""The ``compress_chunks`` entry: one long streamed ``api.compress_chunks``
call, a user encoding a feed into self-contained GOP streams.

Its mix's parameters: ``pool_gops`` GOP chunks (GOP size + 1 frames
each) cut from one sequence of the mix's content, fed cycled in an order
drawn from the run's seed, ``window`` GOPs deep, closed loop, until the
window ends; ``warmup_answers`` chunks encoded in set-up after
``api.prewarm``.  An answer is one GOP's stream: taken when the call
pulls its chunk from the feed, done when its ``progress`` callback
reports the stream, which is then written out as bytes (what a user
keeps) and dropped.  The tracer ticks in seconds into the window.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

from benchmark import check
from benchmark.drive import feed_order
from benchmark.records import Answer


def _gop(codec: dict) -> int:
    return 2 ** (int(codec["TRLs"]) - 1)


def frame_count(codec: dict, traffic: dict) -> int:
    """The frames of the mix's content a run is fed from."""
    return int(traffic["pool_gops"]) * 2 ** (int(codec["TRLs"]) - 1) + 1


def pieces(codec: dict, traffic: dict, frames, seed: int) -> dict:
    """Each GOP chunk of the pool, by its index."""
    S = _gop(codec)
    pool = int(traffic["pool_gops"])
    return {g: tuple(p[g * S:(g + 1) * S + 1] for p in frames)
            for g in feed_order(seed, pool)}


def setup(ctx):
    from qsvc_tpu_torch import api
    from qsvc_tpu_torch.config import CodecConfig
    from qsvc_tpu_torch.io.yuv import Video
    traffic = ctx.traffic
    cfg = CodecConfig(**ctx.codec)
    S, pool = cfg.gop_size, int(traffic["pool_gops"])
    frames = ctx.frames(frame_count(ctx.codec, traffic), cfg.pixels_in_y,
                        cfg.pixels_in_x)
    video = Video(*frames)
    ctx.step("frames")
    gop_cfg = cfg.replace(GOPs=1)
    chunks = [video[g * S:(g + 1) * S + 1] for g in range(pool)]
    api.prewarm(gop_cfg, reversible=False, device=ctx.device)
    ctx.step("prewarm")
    api.compress_chunks(chunks[:int(traffic["warmup_answers"])], gop_cfg,
                        reversible=False, window=int(traffic["window"]),
                        device=ctx.device)
    ctx.step("warmup")
    return SimpleNamespace(api=api, frames=frames, chunks=chunks,
                           cfg=gop_cfg)


def drive(ctx, state, tracer, on_start):
    seconds = float(ctx.spec["seconds"])
    order = feed_order(ctx.spec["seed"], len(state.chunks))
    S = state.cfg.gop_size
    pixels = state.cfg.pixels_in_x * state.cfg.pixels_in_y
    answers, outputs, clock = [], {}, {}

    def feed():
        i = 0
        while True:
            now = time.time()
            if i == 0:
                clock["t0"] = now
                on_start(now)
            elif now >= clock["t0"] + seconds:
                tracer.stop()
                return
            tracer.tick(now - clock["t0"])
            item = order[i % len(order)]
            answers.append(Answer(item, now, frames=S + 1, pixels=pixels,
                                  advance=S))
            yield state.chunks[item]
            i += 1

    def progress(index, vs):
        answers[index].t_done = time.time()
        data = vs.to_bytes()
        answers[index].nbytes = len(data)
        outputs[index] = data

    state.api.compress_chunks(feed(), state.cfg, reversible=False,
                              window=int(ctx.traffic["window"]),
                              progress=progress, device=ctx.device)
    return answers, outputs


def judge(ctx, state, answers, outputs):
    return check.judge_streams(
        ctx, pieces(ctx.codec, ctx.traffic, state.frames, ctx.spec["seed"]),
        answers, outputs)
