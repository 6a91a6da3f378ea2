"""The ``compress_distributed`` entry: back-to-back halo-exact sharded
encodes of one sequence over the cell's ranks, a user encoding one
sequence on a multi-card host into one stream.

Its mix's parameters: a sequence of ``pool_gops`` GOPs of the mix's
content, ``gops_per_rank`` on each rank; ``warmup_answers`` calls in
set-up.  Rank 0's clock decides before each call whether the window
still runs and broadcasts it.  An answer is one call; rank 0, which
writes the stream out, serializes it as the call's last step and holds
nothing else of it.  Every call is the same work, so the run's seed
changes nothing here.  The tracer ticks in calls, so that every rank
traces the same calls.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

from benchmark import check
from benchmark.records import Answer


def frame_count(codec: dict, traffic: dict) -> int:
    """The frames of the mix's content a run is fed from."""
    return int(traffic["pool_gops"]) * 2 ** (int(codec["TRLs"]) - 1) + 1


def pieces(codec: dict, traffic: dict, frames, seed: int) -> dict:
    """The whole sequence, the one item."""
    return {0: tuple(frames)}


def setup(ctx):
    from qsvc_tpu_torch.config import CodecConfig
    from qsvc_tpu_torch.io.yuv import Video
    from qsvc_tpu_torch.parallel import distributed
    spec, traffic = ctx.spec, ctx.traffic
    cfg = CodecConfig(**ctx.codec)
    pool, world = int(traffic["pool_gops"]), spec["world"]
    if pool != world * int(traffic["gops_per_rank"]):
        raise ValueError(f"{pool} GOPs are not {traffic['gops_per_rank']}"
                         f" a rank on {world} ranks")
    frames = ctx.frames(frame_count(ctx.codec, traffic), cfg.pixels_in_y,
                        cfg.pixels_in_x)
    video = Video(*frames)
    ctx.step("frames")
    distributed.initialize(ctx.device, init_method=f"file://{spec['store']}",
                           world_size=world, rank=spec["rank"])
    ctx.step("group")
    gop_cfg = cfg.replace(GOPs=pool)
    for _ in range(int(traffic["warmup_answers"])):
        distributed.compress_distributed(video, gop_cfg, reversible=False)
    ctx.step("warmup")
    return SimpleNamespace(distributed=distributed, frames=frames,
                           video=video, cfg=gop_cfg)


def _go(flag: bool, device) -> bool:
    """Rank 0's ``flag``, broadcast to every rank."""
    import torch
    import torch.distributed as dist
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=device)
    dist.broadcast(t, src=0)
    return bool(t.item())


def drive(ctx, state, tracer, on_start):
    import torch.distributed as dist
    seconds = float(ctx.spec["seconds"])
    keep = ctx.spec["rank"] == 0
    n = state.cfg.pictures
    pixels = state.cfg.pixels_in_x * state.cfg.pixels_in_y
    answers, outputs = [], {}
    dist.barrier()
    t0 = time.time()
    on_start(t0)
    while True:
        now = time.time()
        if not _go(now < t0 + seconds, ctx.device):
            break
        tracer.tick(len(answers))
        answers.append(Answer(0, now, frames=n, pixels=pixels, advance=n))
        vs = state.distributed.compress_distributed(state.video, state.cfg,
                                                    None, reversible=False)
        if keep:
            data = vs.to_bytes()
            answers[-1].nbytes = len(data)
            outputs[len(answers) - 1] = data
        answers[-1].t_done = time.time()
        del vs
    tracer.stop()
    state.distributed.end_group()
    return answers, outputs


def judge(ctx, state, answers, outputs):
    return check.judge_streams(
        ctx, pieces(ctx.codec, ctx.traffic, state.frames, ctx.spec["seed"]),
        answers, outputs)
