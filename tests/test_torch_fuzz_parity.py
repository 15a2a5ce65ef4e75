"""The port's CLI against the JAX package's on generated patterns and trees.

The pattern grammar, samplers and trees of ``tests/test_grep_fuzz.py``
(loaded from its file, unchanged), with its seeds: 200-223 for regexes
(``-r PAT``), 300-305 for fixed strings (``-r -S LIT``). Each seed runs
``grab_tpu_torch.cli`` (device cpu: the kernels' plain PyTorch versions)
and ``grab_tpu.cli`` over the same tree. Tolerance: stdout and exit code
byte for byte; no ``grep -P`` is needed.
"""

import importlib.util
import io
import os

import numpy as np
import pytest

from grab_tpu import cli as ref_cli
from grab_tpu_torch import cli as port_cli
from tests._torch_threads import _one_thread  # noqa: F401 (autouse: one intra-op thread)

_spec = importlib.util.spec_from_file_location(
    "grab_tpu_fuzz_generators",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_grep_fuzz.py"),
)
_fuzz = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_fuzz)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("GRAB_TPU_TORCH_DEVICE", "cpu")


def _run(cli, argv):
    out, err = io.BytesIO(), io.StringIO()
    rc = cli.main(list(argv), out=out, err=err)
    return rc, out.getvalue()


def _same(argv, what):
    ref = _run(ref_cli, argv)
    got = _run(port_cli, argv)
    assert ref[0] == 0, what
    assert got == ref, what


@pytest.mark.parametrize("seed", range(200, 224))
def test_fuzz_regex_equals_reference(tmp_path, seed):
    rng = np.random.default_rng(seed)
    pat, sampler = _fuzz.gen_pattern(rng)
    _fuzz.build_fuzz_tree(tmp_path, rng, sampler)
    _same(["-r", pat, str(tmp_path)], f"seed={seed} pattern={pat!r}")


@pytest.mark.parametrize("seed", range(300, 306))
def test_fuzz_literal_equals_reference(tmp_path, seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(3, 12))
    lit = "".join(rng.choice(list(_fuzz.LETTERS + "0123456789_."), k))
    _fuzz.build_fuzz_tree(tmp_path, rng, lambda rng, lit=lit: lit)
    _same(["-r", "-S", lit, str(tmp_path)], f"seed={seed} literal={lit!r}")
