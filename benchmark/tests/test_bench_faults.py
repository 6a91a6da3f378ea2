"""The check fails each fault a cell can have: the run is driven whole on
the CPU (no card to look for) with the program broken underneath, and
``correct`` comes out false."""

import json

import pytest

from benchmark import run

STREAMED = ["update_unchanged", "half_batch", "altered_answer"]
SHARDED = STREAMED + ["no_exchange"]
CASES = ([("hd1080-lossy.encode", f) for f in STREAMED]
         + [("hd1080-lossy-4card.encode", f) for f in SHARDED])


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(capsys, tiny_root, cell, fault):
    rc = run.main(["--workload", cell, "--seed", "3000000001", "--seconds",
                   "3"], device="cpu", root=tiny_root,
                  fault=f"benchmark.tests.faults:{fault}")
    out, err = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is False
    assert any(v["value"] is None or v["value"] > v["limit"]
               for v in line["compared"].values())
