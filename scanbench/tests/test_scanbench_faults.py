"""Whole runs on the CPU at a tiny size: a sound run of each cell comes
out correct; with the timed path broken underneath (half of each batch
left out, or an answer altered where the emitter produces it) it comes
out not correct; and the control (the reference with one guarantee
broken) fails the comparison every cell's run makes."""

import sys

import pytest

from scanbench.control import control_counts
from scanbench.tests.tiny import TINY, cpu_run

CELLS = ["linux_src.requests", "log_ioc.hunt"]
FAULTS = ["half_batch", "altered_answer"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tmp_path, cell):
    rc, res = cpu_run(cell, 2**31 + 1001, 1.0, 1 if cell == "linux_src.requests" else 0, tmp=tmp_path)
    assert rc == 0 and res["correct"] is True, res
    assert res["checks"]["stdout_mismatches"]["value"] == 0


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_makes_run_incorrect(tmp_path, cell, fault):
    cmd = [sys.executable, "-m", "scanbench.tests.faulty_server", fault]
    rc, res = cpu_run(cell, 2**31 + 2002, 1.0, 0, server_cmd=cmd, tmp=tmp_path)
    assert rc == 0 and res["correct"] is False, res
    assert res["checks"]["stdout_mismatches"]["value"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_comparison(tmp_path, monkeypatch, cell):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    counts, compared = control_counts(cell, 2**31 + 3003, 40, 2, TINY[cell.split(".")[0]], str(tmp_path / "cache"))
    assert compared >= 1
    assert counts["stdout_mismatches"] >= 1
