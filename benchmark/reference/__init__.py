"""The benchmark's plain reference encoder.

A frozen copy of the plain PyTorch paths of ``qsvc_tpu_torch`` (the
versions its kernels are tested against), cut to the encode: the MCTF
analysis (ME, prediction, update, motion decorrelation), the texture DWT,
quantization, code-block tiling, the bp R-D simulation and the block
selection, plus a bit-plane ("bp") block coder, the spec MQ coder for
the motion fields and the stream writer; and the way back for the
check: a stream reader (:mod:`.codec.reader`) and a bp block decoder
(:func:`.codec.bp.decode_blocks`).  It imports nothing of the program and
runs every step as plain tensor code on whatever device its input is on.
:func:`.encode.encode` is the entry.
"""
