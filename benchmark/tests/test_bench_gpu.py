"""On the card: one short run of each one-card cell at its full size,
``correct`` and every end-to-end metric there.  Skipped without a card;
``python3 -m pytest -q -p no:cacheprovider benchmark/tests -m gpu`` runs
it on the card."""

import json

import pytest

from benchmark import run, spec as specs


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  specs.load_benchmark()["workloads"]
                                  if w["chips"] == 1])
def test_cell_on_the_card(capsys, cell):
    from .conftest import cuda_available
    if not cuda_available():
        pytest.skip("needs a CUDA device")
    rc = run.main(["--workload", cell, "--seed", "2147483659",
                   "--seconds", "5"])
    out, _ = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {
        m["name"] for m in specs.load_cell(cell).end_to_end}
