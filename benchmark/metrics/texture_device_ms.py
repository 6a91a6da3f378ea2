"""``texture_device_ms``: per GOP, the card's time in the captured
texture program (``graph._encode_device`` device spans: the DWT,
quantization, tiling and bp R-D simulation of the luma and the chroma
stack, copies in and out included), in ms."""

from benchmark.metrics._spans import device_ms


def read(run):
    return device_ms(run, "graph._encode_device")
