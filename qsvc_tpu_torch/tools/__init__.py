"""The port's measurement and evidence entry points, each under the name
of its counterpart in the JAX package: :mod:`.bench` (``bench.py``),
:mod:`.bench_decode` (``tools/bench_decode.py``) and :mod:`.rd_harness`
(``tools/rd_harness.py``); :mod:`.spread` runs the two benches again
and again in fresh processes and reports their run-to-run spread.

The attribution tools, card only: :mod:`.profile_stages`,
:mod:`.profile_mctf`, :mod:`.profile_decode` (``tools/profile_decode5.py``),
:mod:`.profile_pipeline` (``tools/profile_round3.py``),
:mod:`.profile_warmup`, :mod:`.profile_hbm`, :mod:`.profile_transfer`
(``tools/profile_upload.py``) and :mod:`.profile_dispatch`; :mod:`.profile`
holds their device profile (``torch.profiler`` over a window, its busy
share, top operations and idle gaps by ``utils.trace`` stage)."""
