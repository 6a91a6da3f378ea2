"""A whole run on the CPU at a small size: the last line's keys, the
compared numbers, the launcher's host split and its rendezvous under
``TMPDIR``."""

import json
import os

import pytest

from benchmark import check, run, spec as specs

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(capsys, root, cell, trace, seconds=3, seed=2**31 + 11, **kw):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], device="cpu",
                  root=root, **kw)
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("trace", [0, 1])
def test_streamed_cell_last_line(capsys, tiny_root, trace):
    rc, out, err = _run(capsys, tiny_root, "hd1080-lossy.encode", trace)
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    want = KEYS + (["breakdown"] if trace else []) + ["compared"]
    assert list(line) == want
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    cell = specs.load_cell("hd1080-lossy.encode", tiny_root)
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        names = {m["name"] for m in cell.per_layer}
    else:
        names = {m["name"] for m in cell.end_to_end}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    compared = line["compared"]
    assert list(compared) == list(check.LIMITS)
    assert compared["layout_differing"]["value"] == 0
    assert compared["answers_missing"]["value"] == 0
    # the program and the reference agree here to the byte
    assert compared["rd_cost_excess_pct"]["value"] == 0.0
    # the compared numbers are the last lines of standard error
    assert err.strip().splitlines()[-len(compared):] == [
        f"compared {k}: {v['value']} (limit {v['limit']})"
        for k, v in compared.items()]


def test_sharded_cell_runs_four_ranks(capsys, tiny_root):
    rc, out, _ = _run(capsys, tiny_root, "hd1080-lossy-4card.encode", 0)
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["count"] == 4
    assert set(line["metrics"]) == {"stream_bpp", "setup_s"}


def test_unknown_workload_prints_no_result(capsys, tiny_root):
    rc, out, _ = _run(capsys, tiny_root, "no-such.cell", 0)
    assert rc == 2 and out == ""


def test_host_split_per_rank():
    cores = list(range(32))
    shares = run.host_split(cores, 4, True)
    assert shares == [list(range(8 * r, 8 * r + 8)) for r in range(4)]
    assert run.host_split(cores, 4, False) == [None] * 4
    assert run.host_split([0, 1], 4, True) == [None] * 4
    env = run.rank_env(shares[2])
    assert env["OMP_NUM_THREADS"] == "8"
    for key in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):
        assert env[key].startswith(specs.ROOT + os.sep)
    assert run.rank_env(None).get("OMP_NUM_THREADS") == os.environ.get(
        "OMP_NUM_THREADS")


def test_rendezvous_and_results_under_tmpdir(monkeypatch, tmp_path,
                                             tiny_root):
    seen = {}

    def fake_launch(cell, args, workdir, device, fault):
        seen["workdir"] = workdir
        seen["exists"] = os.path.isdir(workdir)
        return [{"rank": 0, "stage": "setup", "error": "stopped"}]
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    monkeypatch.setattr(run, "launch", fake_launch)
    rc = run.main(["--workload", "hd1080-lossy-4card.encode", "--seed", "1",
                   "--seconds", "1"], device="cpu", root=tiny_root)
    assert rc == 2
    assert seen["exists"]
    assert os.path.commonpath([seen["workdir"], str(tmp_path)]) \
        == str(tmp_path)
    assert not os.path.exists(seen["workdir"])      # removed after


def test_failed_rank_gives_correct_false(capsys, tiny_root):
    rc, out, _ = _run(capsys, tiny_root, "hd1080-lossy-4card.encode", 0,
                      seconds=6, fault="benchmark.tests.faults:rank1_fails")
    assert rc == 1
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is False


def test_launcher_imports_neither_torch_nor_the_program():
    """The launcher's own process stays light: ``import torch`` is each
    rank's set-up, paid once per rank, in parallel."""
    import subprocess
    import sys
    code = ("import sys; import benchmark.run, benchmark.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'torch', 'qsvc_tpu_torch', 'numpy'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=specs.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]
