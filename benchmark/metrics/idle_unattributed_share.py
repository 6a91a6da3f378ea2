"""``idle_unattributed_share``: of the card's idle time in the traced
window, the share in which no host span of the program was open (the
gaps' ``_no_stage_`` label), in %.

Idle is where no kernel, copy or fill ran; ``_no_stage_`` is where
neither they ran nor a host span was open, so the share is the window
less the union of both, over the window less the operations' union."""

from benchmark.timeline import clip, covered, stage_intervals


def read(run):
    tr = run.trace
    if tr is None or tr.end <= tr.start or not tr.ops:
        return None
    busy = [(a, b) for _, a, b in tr.ops]
    window = tr.end - tr.start
    idle = window - covered(clip(busy, tr.start, tr.end))
    if idle <= 0:
        return None
    hosts = [(a, b) for _, a, b in stage_intervals(run.spans)]
    unattributed = window - covered(clip(busy + hosts, tr.start, tr.end))
    return 100.0 * unattributed / idle
