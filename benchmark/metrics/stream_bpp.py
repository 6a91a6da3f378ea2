"""``stream_bpp``: the bits of every stream finished inside the window
over the frames they code times the luma pixels of a frame."""


def read(run):
    done = [a for a in run.finished() if a.nbytes is not None]
    pixels = sum(a.frames * a.pixels for a in done)
    if not pixels:
        return None
    return sum(8 * a.nbytes for a in done) / pixels
