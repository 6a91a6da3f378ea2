"""``gc_pause_ms.sharded``: per sharded call, rank 0's seconds in
Python's garbage collector (the program's ``gc.collect`` spans), in
ms: ``gc_pause_ms``'s reader over the sharded cell's run."""

from benchmark.metrics.gc_pause_ms import read  # noqa: F401
