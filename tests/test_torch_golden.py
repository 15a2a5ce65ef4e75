"""The port's numpy golden scanners against the JAX package's.

Each package compiles the same patterns into its own DFA; the tables are
compared first (transition table, class map, accept mask, start state),
then ``dfa_scan_ends``, ``dfa_scan_ends_fast``, ``literal_scan_starts``
and ``block_counts`` on seeded data. Tolerance: 0 (booleans and counts).
"""

import numpy as np
import pytest

from grab_tpu import golden as ref_golden
from grab_tpu.golden.scanner import dfa_scan_ends_fast as ref_fast
from grab_tpu.regex.compiler import compile_multi as ref_compile
from grab_tpu_torch import golden
from grab_tpu_torch.regex.compiler import compile_multi as port_compile

PATTERNS = [[rb"needle"], [rb"ne+dle", rb"foo|bar"], [rb"n[a-f]+le"], [rb"[0-9]{3}[a-z]{2}"],
            [rb"(?i)hello\s+world"], [rb"\bx[^\n]{0,6}y"]]


def seeded(n, seed, needles=(b"needle", b"neeedle", b"nacle", b"123ab", b"HeLLo  world",
                             b"x..y", b"foo")):
    rng = np.random.default_rng(seed)
    data = rng.integers(32, 127, size=n, dtype=np.uint8)
    data[rng.random(n) < 0.02] = 0x0A
    for i, s in enumerate(needles):
        for pos in (97 * i + 5, n // 2 + 31 * i, n - len(s)):
            data[pos : pos + len(s)] = np.frombuffer(s, np.uint8)
    return data


def dfas(patterns):
    want, got = ref_compile(patterns).dfa, port_compile(patterns).dfa
    assert np.array_equal(got.table, want.table) and got.table.dtype == want.table.dtype
    assert np.array_equal(got.class_map, want.class_map)
    assert np.array_equal(got.accept_mask, want.accept_mask)
    assert got.start == want.start
    return want, got


@pytest.mark.parametrize("patterns", PATTERNS, ids=repr)
def test_dfa_scans_equal(patterns):
    want_dfa, dfa = dfas(patterns)
    data = seeded(3000, 61)
    got = golden.dfa_scan_ends(dfa, data)
    assert got.dtype == bool and np.array_equal(got, ref_golden.dfa_scan_ends(want_dfa, data))
    fast = golden.dfa_scan_ends_fast(dfa, data)
    assert np.array_equal(fast, ref_fast(want_dfa, data)) and np.array_equal(fast, got)
    assert got.any()


@pytest.mark.parametrize("lits", [[b"needle"], [b"foo", b"oo", b"o"], [b"123ab", b"zz\x00"], []])
def test_literal_scan_starts_equal(lits):
    data = seeded(5000, 62).tobytes() + b"zz"
    got = golden.literal_scan_starts(lits, data)
    assert np.array_equal(got, ref_golden.literal_scan_starts(lits, data))
    assert got.any() == bool(lits)


@pytest.mark.parametrize("block", [1, 7, 512])
@pytest.mark.parametrize("n", [0, 511, 512, 4099])
def test_block_counts_equal(block, n):
    bitmap = np.random.default_rng(63 + n).random(n) < 0.1
    got = golden.block_counts(bitmap, block)
    want = ref_golden.block_counts(bitmap, block)
    assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want)
    assert got.shape == (-(-n // block),) and int(got.sum()) == int(bitmap.sum())
