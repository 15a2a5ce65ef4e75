"""The plain reference on hand-made cases and against a naive search
loop (one re.search per step, as tests/oracle.py does)."""

import os
import re

import numpy as np
import pytest

from scanbench import reference as R


def naive(path, data, pats, literal, chunk=R.CHUNK, control=False):
    rxs = [re.compile(re.escape(p) if literal else p) for p in pats]
    never = [(not literal) and r.groups > 0 for r in rxs]
    minlen = min(R.sre_parse.parse(r.pattern).getwidth()[0] for r in rxs)
    size, out = len(data), b""
    if minlen > size:
        return b""
    off = 0
    while off < size:
        end, buf = min(off + chunk, size), b""
        start = off
        while start + minlen < end:
            best = None
            for r, nv in zip(rxs, never):
                if nv:
                    continue
                pos = start
                while True:
                    m = r.search(data, pos, end)
                    if m is not None and control and m.start() // 512 != (m.end() - 1) // 512:
                        pos = m.start() + 1
                        continue
                    break
                if m is not None and (best is None or m.start() < best[0]):
                    best = (m.start(), m.end())
            if best is None:
                break
            ms, me = best
            buf += path.encode() + b":"
            b0 = ms
            while b0 > start and data[b0 - 1] != 10 and ms - b0 < 511:
                b0 -= 1
            ae, a = me, 0
            while ae < end and data[ae] != 10 and a < 511:
                ae += 1
                a += 1
            buf += data[b0:ae] + b"\n"
            ns = me + a
            start = ns + 1 if ns == start else ns
        out += buf
        off += chunk - 0x1000
    return out


def out(data, pats, literal=False, **kw):
    return R.file_output("d/f", data, [R.Pattern(p, literal) for p in pats], **kw)


def test_no_trailing_newline_and_context_caps():
    assert out(b"ab\nxx needle", [b"needle"]) == b"d/f:xx needle\n"
    long = b"a" * 600 + b"needle" + b"b" * 600
    assert out(long, [b"needle"]) == b"d/f:" + b"a" * 511 + b"needle" + b"b" * 511 + b"\n"
    # restart after the printed after-context: one report per line
    assert out(b"needle needle\nneedle\n", [b"needle"]) == b"d/f:needle needle\nd/f:needle\n"
    # the file ends in the match: the emit loop's `start + minlen < end` still sees it
    assert out(b"x\nneedle", [b"needle"]) == b"d/f:needle\n"
    assert out(b"needle", [b"needle"]) == b""  # start + minlen == end: grab stops first


def test_chunk_boundary_overlap_duplicates():
    data = bytearray(b"." * 20000)
    for i in range(0, 20000, 100):
        data[i] = 10
    data[8192 - 50 : 8192 - 44] = b"needle"  # inside the 4 KiB overlap: reported by both chunks
    got = out(bytes(data), [b"needle"], chunk=8192)
    assert got.count(b"needle") == 2
    assert got == naive("d/f", bytes(data), [b"needle"], False, chunk=8192)
    data[8192 - 3 : 8192 + 3] = b"needle"  # across the first chunk's end: the second chunk sees it
    assert out(bytes(data), [b"needle"], chunk=8192) == naive("d/f", bytes(data), [b"needle"], False, chunk=8192)


def test_batch_leftmost_then_earlier_pattern_and_capture_quirk():
    data = b"xx abcdefjkl colour zzbzz\n"
    assert out(data, [rb"abc(def|ghi)jkl"]) == b""  # PCRE1: a capturing pattern never matches
    assert out(data, [rb"abc(def|ghi)jkl", rb"colou?r"]) == b"d/f:xx abcdefjkl colour zzbzz\n"
    # ties go to the earlier pattern, the extent is its own
    assert R.file_output("d/f", b"q colourful\n", [R.Pattern(p, False) for p in (rb"colo", rb"colou?r")],
                         recursive=False) == b"q colourful\n"


def test_control_misses_a_match_across_a_512_byte_block():
    data = bytearray(b"." * 2000)
    data[512 - 3 : 512 + 3] = b"needle"
    assert out(bytes(data), [b"needle"]).count(b"needle") == 1
    assert out(bytes(data), [b"needle"], control=True) == b""


@pytest.mark.parametrize("trial", range(12))
def test_against_naive_loop(trial):
    rng = np.random.default_rng(trial)
    alpha = np.frombuffer(b"abcdefoqurxyzwlnAQWERTY0123456789-\n\t .z", np.uint8)
    lits = [bytes(rng.integers(97, 123, size=int(rng.integers(4, 8)), dtype=np.uint8)) for _ in range(20)]
    regs = [rb"foo[a-z]{2,6}bar", rb"[0-9]{3}-[0-9]{4}", rb"qu+x", rb"colou?r", rb"abc(def|ghi)jkl",
            rb"w[xyz]{3}w", rb"nee+dle", rb"[A-Z]{5}99", rb"zz(?:a|b|c)zz", rb"end\.x", rb".{0,2}[0-9]{11}",
            rb"\t[0-9]+\t", rb"[A-Z]{6}[0-9]{6}", rb"foo[a-z]+bar"]
    plants = [b"fooabbar", b"123-4567", b"quuux", b"color", b"abcdefjkl", b"wxyzw", b"neeedle", b"QWERT99",
              b"zzbzz", b"end.x", b"12345678901234", b"\t42\t", b"QWERTY123456"]
    n = int(rng.integers(1, 30000))
    data = bytearray(rng.choice(alpha, size=n).tobytes())
    for _ in range(int(rng.integers(0, 30))):
        t = plants[int(rng.integers(0, len(plants)))] if rng.random() < 0.6 else lits[int(rng.integers(0, 20))]
        p = int(rng.integers(0, max(1, n - len(t))))
        data[p : p + len(t)] = t[: n - p]
    data = bytes(data)
    chunk = [R.CHUNK, 8192, 4097 + int(rng.integers(1, 5000))][trial % 3]
    for pats, lit in [(lits + regs, False), (regs[trial:trial + 1], False), (lits[:1], True), (lits[:7], True)]:
        for control in (False, True):
            assert out(data, pats, lit, chunk=chunk, control=control) == naive("d/f", data, pats, lit, chunk, control)


def test_walk_order_files_before_subdirectories(tmp_path):
    for rel in ["b/x", "a", "c", "b/a/y", "b2"]:
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(b"z")
    (tmp_path / "link").symlink_to(tmp_path / "a")
    got = [os.path.relpath(p, tmp_path) for p, _ in R.walk(str(tmp_path))]
    assert got == ["a", "b2", "c", "b/x", "b/a/y"]
