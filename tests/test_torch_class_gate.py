"""The replay's class-sequence gate (engine.py _ClassGatedMatcher) on
the CPU: for patterns without a literal factor of two bytes or more, the
gate answers every search exactly as the bare exact matcher does, on the
same (data, lo, hi, alo, ahi), in PCRE1 and PCRE2 mode; a window with no
occurrence of a sequence never reaches the matcher; the counters add up
to the searches made; and the Engine builds the gate only where the
pattern's own AST gives a selective sequence set, with output equal to
the JAX package's host scan."""

import json
import random
from pathlib import Path

import pytest

from grab_tpu_torch.engine import (
    Engine,
    EngineConfig,
    _ClassGatedMatcher,
    _FactorGatedMatcher,
    _FactorSeededMatcher,
    _MultiMatcher,
)
from grab_tpu_torch.format.emitter import OutputConfig
from grab_tpu_torch.regex import ast as A
from grab_tpu_torch.regex import pcre2
from grab_tpu_torch.regex.backtrack import Matcher
from grab_tpu_torch.regex.parser import parse
from scanbench.corpus.log_ioc import line_pool

ROOT = Path(__file__).resolve().parents[1]

# pattern, strings it matches, strings that hold a sequence occurrence
# (or start like a match) and do not match
PATTERNS = {
    # the -H sweep's regexes without a literal gate
    "sweep_phone": (rb"[0-9]{3}-[0-9]{4}", [b"555-0123", b"867-5309"], [b"555-012", b"55-01234"]),
    "sweep_qux": (rb"qu+x", [b"qux", b"quuuux"], [b"quuq", b"quu x"]),
    "sweep_wxyzw": (rb"w[xyz]{3}w", [b"wxyzw", b"wzzxw"], [b"wxyzq", b"wxyw"]),
    # the source-tree requests' regexes without one
    "src_caps": (rb"[A-Z]{6}[0-9]{6}", [b"QWERTY123456"], [b"QWERTY12345x", b"QWERTY1234"]),
    "src_tabs": (rb"\t[0-9]+\t", [b"\t42\t", b"\t7\t"], [b"\t42x", b"\t\t"]),
    "src_digits": (rb".{0,2}[0-9]{11}", [b"ab01234567890"], [b"ab0123456789x"]),
    # flags, anchors, word boundaries, lookbehind
    "nocase": (rb"(?i)qu+x", [b"QuUx", b"qUX"], [b"QUUQ"]),
    "caret": (rb"^[0-9]{3}-[0-9]{4}", [b"555-0123"], [b"555-012"]),
    "dollar": (rb"qu+x$", [b"quux\n"], [b"quuxa"]),
    "word": (rb"\bqu+x\b", [b" quux "], [b"aquux", b"quux1"]),
    "lookbehind": (rb"(?<![0-9])[0-9]{3}-[0-9]{4}", [b" 555-0123"], [b"1555-0123"]),
    "lookbehind_pos": (rb"(?<=a)qu+x", [b"aqux"], [b"bqux"]),
    # sequences of two lengths: a short one may start past hi inside the search
    "two_lengths": (rb"(?:[QZ]x|[~^])[0-9]", [b"~2", b"Qx1"], [b"~z", b"Qxz"]),
}
MODES = [("pcre1", k) for k in PATTERNS] + [
    ("pcre2", k) for k in ("sweep_phone", "sweep_qux", "word", "lookbehind")
]
SITUATIONS = ("at_lo", "at_hi", "failing", "overlapping", "past_hi", "crosses_ahi", "random")


def _bare(pattern: bytes, mode: str):
    if mode == "pcre2":
        if not pcre2.available():
            pytest.skip("no libpcre2")
        return pcre2.PCRE2Pattern(pattern)
    return Matcher.from_pattern(pattern)


def _gate(inner, pattern: bytes):
    seqs = A.device_class_sequences(parse(pattern))
    assert seqs, pattern
    return _ClassGatedMatcher(inner, seqs)


@pytest.fixture(scope="module")
def lines():
    cfg = json.loads((ROOT / "scanbench/configs/log_ioc_h110.json").read_text())
    cfg["pool_lines"] = 400
    return line_pool(cfg, 13)


def _text(lines, seed: int, n: int = 40) -> bytearray:
    r = random.Random(seed)
    return bytearray(b"".join(r.choice(lines) for _ in range(n)))


def _plant(buf: bytearray, s: bytes, at: int) -> int:
    """Overwrite ``buf`` with ``s`` at ``at``; its start."""
    buf[at : at + len(s)] = s
    return at


def _cases(lines, key: str, situation: str):
    """(data, lo, hi, ahi) of one situation: the windows the replay asks of
    a matcher, around planted strings."""
    _, hits, fails = PATTERNS[key]
    r = random.Random(f"{key}/{situation}")
    out = []
    for k, s in enumerate(hits + fails if situation in ("failing", "random") else hits):
        buf = _text(lines, 100 + k)
        p = len(buf) // 2 + r.randrange(200)
        if situation == "failing":
            s = fails[k % len(fails)]
        elif situation == "overlapping":
            s = s[:-1] + s + s[1:] + s
        _plant(buf, s, p)
        data = bytes(buf)
        ls = data.rfind(b"\n", 0, p) + 1
        le = data.find(b"\n", p)
        le = len(data) if le < 0 else le
        if situation == "at_lo":
            out += [(data, p, le, le), (data, p, le, None), (data, p, p, len(data))]
        elif situation == "at_hi":
            out += [(data, ls, p, len(data)), (data, ls, p, le), (data, p - 1, p, len(data))]
        elif situation in ("failing", "overlapping"):
            out += [(data, ls, le, le), (data, ls, le, len(data)), (data, p, le, None)]
        elif situation == "past_hi":
            out += [(data, ls, p - 1, len(data)), (data, ls, p - 1, None), (data, ls, p - 1, p + 2)]
        elif situation == "crosses_ahi":
            out += [(data, ls, p, p + len(s) - 1), (data, ls, le, p + len(s) - 1), (data, p, p, p + 1)]
        else:
            for _ in range(12):
                lo = r.randrange(len(data) - 1)
                hi = min(len(data), lo + r.randrange(1, 1500))
                out.append((data, lo, hi, r.choice((None, hi, len(data)))))
    return out


@pytest.mark.parametrize("situation", SITUATIONS)
@pytest.mark.parametrize("mode,key", MODES, ids=[f"{m}-{k}" for m, k in MODES])
def test_gate_equals_bare_matcher(lines, mode, key, situation):
    pattern = PATTERNS[key][0]
    bare = _bare(pattern, mode)
    gate = _gate(_bare(pattern, mode), pattern)
    n = 0
    for data, lo, hi, ahi in _cases(lines, key, situation):
        ls = data.rfind(b"\n", 0, lo) + 1
        for alo in (None, lo, ls):
            want = bare.search(data, lo, hi, alo=alo, ahi=ahi)
            if mode == "pcre2" and want is not None and want[0] > hi:
                want = None  # pcre2 does not stop at hi; no match starts by hi
            got = gate.search(data, lo, hi, alo=alo, ahi=ahi)
            assert got == want, (situation, lo, hi, alo, ahi, data[lo : hi + 16])
            n += 1
    assert gate.cleared + gate.passed == n


def test_planted_matches_are_found(lines):
    """The cases above find what they plant, so equality is not vacuous."""
    for key, (pattern, hits, _) in PATTERNS.items():
        gate = _gate(Matcher.from_pattern(pattern), pattern)
        found = [
            gate.search(data, lo, hi, alo=lo if key == "caret" else None, ahi=ahi)
            for data, lo, hi, ahi in _cases(lines, key, "at_lo")
        ]
        assert any(f is not None for f in found), key


class _Spy:
    def __init__(self, inner):
        self.inner, self.calls = inner, 0

    def search(self, data, lo, hi, alo=None, ahi=None):
        self.calls += 1
        return self.inner.search(data, lo, hi, alo=alo, ahi=ahi)


@pytest.mark.parametrize(
    "key", ["sweep_phone", "sweep_qux", "sweep_wxyzw", "src_caps", "src_tabs", "two_lengths"]
)
def test_window_without_occurrence_never_reaches_the_matcher(lines, key):
    pattern, hits, _ = PATTERNS[key]
    data = bytes(_text(lines, 7, 200))
    spy = _Spy(Matcher.from_pattern(pattern))
    gate = _gate(spy, pattern)
    rx = gate.rx
    r = random.Random(key)
    clear = 0
    for _ in range(300):
        lo = r.randrange(len(data) - 600)
        hi = data.find(b"\n", lo + 1)
        occ = rx.search(data, lo, min(len(data), hi + gate.max_len))
        if occ is None or occ.start() > hi:
            clear += 1
            assert gate.search(data, lo, hi, alo=lo, ahi=len(data)) is None
    assert clear > 200 and spy.calls == 0
    assert (gate.cleared, gate.passed) == (clear, 0)
    buf = bytearray(data)
    p = _plant(buf, hits[0], 5000)
    data = bytes(buf)
    ls = data.rfind(b"\n", 0, p) + 1
    # an occurrence starting just past hi clears too
    assert gate.search(data, ls, p - 1, alo=ls, ahi=len(data)) is None
    assert spy.calls == 0 and (gate.cleared, gate.passed) == (clear + 1, 0)
    assert gate.search(data, ls, data.find(b"\n", p), alo=ls, ahi=len(data)) is not None
    assert spy.calls == 1 and (gate.cleared, gate.passed) == (clear + 1, 1)


@pytest.fixture(scope="module")
def batch():
    """A small -H batch: the sweep's three factor-less regexes beside
    factor-gated regexes and literals, as ioc110.txt mixes them."""
    pats = [l for l in (ROOT / "scanbench/patterns/ioc110.txt").read_bytes().splitlines() if l]
    regexes = [p for p in pats if any(c in p for c in b"[]()+?{}\\.")]
    return regexes + [p for p in pats if p not in regexes][:6]


def _engine(pats, **kw):
    return Engine(pats, EngineConfig(output=OutputConfig(), device="none", **kw))


def test_engine_gates_only_factor_less_patterns(batch):
    e = _engine(batch)
    assert isinstance(e._exact, _MultiMatcher)
    gated = {p for p, m in zip(batch, e._exact.matchers) if isinstance(m, _ClassGatedMatcher)}
    assert gated == {rb"[0-9]{3}-[0-9]{4}", rb"qu+x", rb"w[xyz]{3}w"}
    assert e._gates == [m for m in e._exact.matchers if isinstance(m, _ClassGatedMatcher)]
    for p, kinds in [
        (rb"foo[a-z]{2,6}bar", (_FactorSeededMatcher, _FactorGatedMatcher)),
        (rb"[A-Z]{6}[0-9]{6}", _ClassGatedMatcher),
        (rb"\t[0-9]+\t", _ClassGatedMatcher),
        (rb"(?i)qu+x", _ClassGatedMatcher),
    ]:
        assert isinstance(_engine([p])._exact, kinds), p
    # one 255-byte class clears nearly nothing: left bare
    assert isinstance(_engine([rb".{0,2}[0-9]{11}"])._exact, Matcher)
    assert isinstance(_engine([rb"qu+x"], mode="pcre2")._exact, _ClassGatedMatcher)


@pytest.mark.parametrize("mode", ["pcre1", "pcre2"])
def test_engine_output_and_counters(lines, batch, mode):
    """Host-only scan of planted log text: the port's output equals the
    JAX package's, and seqgate sums the gates' counters."""
    from grab_tpu.engine import Engine as RefEngine
    from grab_tpu.engine import EngineConfig as RefConfig
    from grab_tpu.format.emitter import OutputConfig as RefOutput

    buf = _text(lines, 3, 300)
    r = random.Random(mode)
    plants = (ROOT / "scanbench/patterns/ioc110_plants.txt").read_bytes().splitlines()
    for _ in range(100):
        s = r.choice(plants + [b"quuq", b"555-012", b"wxyw"])
        _plant(buf, s, r.randrange(len(buf) - 40))
    data = bytes(buf)
    e = _engine(batch, mode=mode)
    got = bytearray()
    e.scan_data("mem://log", data, got.extend)
    ref = RefEngine(batch, RefConfig(output=RefOutput(), device="none", mode=mode))
    want = bytearray()
    ref.scan_data("mem://log", data, want.extend)
    assert bytes(got) == bytes(want) and got.count(b"\n") > 20
    cleared = sum(g.cleared for g in e._gates)
    passed = sum(g.passed for g in e._gates)
    assert e.stats.seqgate == (cleared, passed) and cleared > 0 and passed > 0
