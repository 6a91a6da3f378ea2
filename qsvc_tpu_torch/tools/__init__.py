"""The port's measurement and evidence entry points, each under the name
of its counterpart in the JAX package: :mod:`.bench` (``bench.py``),
:mod:`.bench_decode` (``tools/bench_decode.py``) and :mod:`.rd_harness`
(``tools/rd_harness.py``); :mod:`.spread` runs the two benches again
and again in fresh processes and reports their run-to-run spread."""
