"""``interp_device_ms``: per GOP, the card's time in the MCTF's sub-pixel
interpolations and decimations (``mctf.interp`` device spans, each
region of the captured ``analyze`` timed by the stamps captured into
it), in ms."""

from benchmark.metrics._spans import device_ms


def read(run):
    return device_ms(run, "mctf.interp")
