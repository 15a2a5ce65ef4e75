"""The class sequences of a ``-H`` batch's device member
(``regex.ast.device_class_sequences``, ``regex.compiler.device_class_seqs``):
carried past a pattern's first repeat, they must still cover every match
(soundness), must clear the blocks of log text that the compiler's
shorter prefix sequences flag (tightness), and the sweep of greppin's
100 literals + 10 regexes must print what the plain reference prints."""

import io
import json
import os
import re

import numpy as np
import pytest

from grab_tpu_torch import cli as port_cli
from grab_tpu_torch import scan_pipeline
from grab_tpu_torch import server as server_mod
from grab_tpu_torch.regex import ast as A
from grab_tpu_torch.regex.compiler import compile_multi, device_class_seqs, pattern_route
from grab_tpu_torch.regex.parser import parse
from grab_tpu_torch.scan_pipeline import DeviceScanner
from scanbench import reference
from scanbench.corpus import log_ioc, prepare
from scanbench.corpus.textgen import pool_arrays, text_from_pool
from tests._torch_threads import _one_thread  # noqa: F401 (autouse: one intra-op thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH_FILE = os.path.join(ROOT, "scanbench", "patterns", "ioc110.txt")
with open(BATCH_FILE, "rb") as _f:
    BATCH = [ln for ln in _f.read().splitlines() if ln]
REGEXES = BATCH[100:]

# pattern -> strings it matches, planted into the soundness text
SOUND = {
    # fixed repeats
    rb"[0-9]{3}-[0-9]{4}": [b"555-0123", b"000-9999"],
    rb"[A-Z]{5}99": [b"QWERT99", b"AAAAA99"],
    rb"x[a-c]{2}[0-9]{2}y": [b"xab12y", b"xcc90y"],
    rb"(?:ab|cd){3}x": [b"abcdabx", b"cdcdcdx"],
    # open repeats of one class, followed by a part that cannot match empty
    rb"qu+x": [b"qux", b"quuuux"],
    rb"a[0-9]{2,}b": [b"a12b", b"a123456789b"],
    rb"[a-f]{1,3}z9": [b"az9", b"fedz9"],
    rb"colou?r": [b"color", b"colour"],
    rb"w[0-9]+(?=z)z": [b"w1z", b"w99z"],
    # ... at the pattern's end
    rb"zq[0-9]+": [b"zq1", b"zq12345"],
    rb"kk[a-c]*": [b"kk", b"kkabcabc"],
    # ... before a part that can match empty
    rb"m[0-9]+x?y": [b"m1y", b"m22xy"],
    rb"p[a-z]{2,}(?:xy)*q": [b"pabq", b"pzzzxyxyq"],
    # alternations inside repeats
    rb"(?:a|bc){2}d": [b"aad", b"bcad", b"bcbcd"],
    rb"(?:ab|c){2,3}d": [b"abcd", b"cccd", b"ababcd"],
    rb"(?:[0-9]|x)+y": [b"1y", b"x9x9y"],
    rb"\bqq[0-9]{2}": [b" qq12", b"-qq99"],
    # the rest of the batch's regexes
    rb"foo[a-z]{2,6}bar": [b"fooabbar", b"fooqqqqqqbar"],
    rb"abc(def|ghi)jkl": [b"abcdefjkl", b"abcghijkl"],
    rb"w[xyz]{3}w": [b"wxyzw", b"wzzzw"],
    rb"nee+dle": [b"needle", b"neeeedle"],
    rb"zz(?:a|b|c)zz": [b"zzazz", b"zzczz"],
    rb"end\.x": [b"end.x"],
}
assert set(REGEXES) <= set(SOUND)
ALPHABET = np.frombuffer(b"abcdfkmpquwxyzACQRTW0123459-. \n", dtype=np.uint8)


def _text(seed: int, n: int = 200_000) -> bytes:
    rng = np.random.default_rng(seed)
    buf = ALPHABET[rng.integers(0, len(ALPHABET), size=n)]
    plants = [s for ss in SOUND.values() for s in ss]
    for pos in rng.integers(0, n - 16, size=600):
        s = plants[int(rng.integers(0, len(plants)))]
        buf[pos : pos + len(s)] = np.frombuffer(s, dtype=np.uint8)
    return buf.tobytes()


def _holds(seq, data: bytes, pos: int) -> bool:
    return pos + len(seq) <= len(data) and all((m >> data[pos + j]) & 1 for j, m in enumerate(seq))


@pytest.mark.parametrize("pattern", list(SOUND), ids=[p.decode() for p in SOUND])
def test_every_match_start_satisfies_a_sequence(pattern):
    """At every position where a match starts (Python ``re``, every
    start, overlapping), the text satisfies one of the sequences that is
    no longer than the match; each sequence begins with one of the
    compiler's prefix sequences."""
    t = parse(pattern)
    seqs = A.device_class_sequences(t, 8)
    assert seqs and all(1 <= len(s) <= 8 for s in seqs)
    rx = re.compile(b"(?=(" + pattern + b"))")
    starts = 0
    for seed in (1, 2):
        data = _text(seed)
        for m in rx.finditer(data):
            starts += 1
            assert any(_holds(s, data, m.start()) and len(s) <= len(m[1]) for s in seqs), (pattern, m.start())
    assert starts > 0
    old = A.prefix_class_sequences(t, 8)
    if old:
        assert all(any(tuple(s[: len(o)]) == tuple(o) for o in old) for s in seqs)


def test_rules_on_the_batch_regexes():
    """Fixed repeats leave the sequence open; an open one-class repeat
    gives its mandatory copies and one class joined with what follows."""
    D, U = A.DIGIT_MASK, A.UPPER_MASK

    def one(p):
        s = A.device_class_sequences(parse(p), 8)
        assert len(s) == 1
        return s[0]

    assert one(rb"[0-9]{3}-[0-9]{4}") == (D, D, D, 1 << ord("-"), D, D, D, D)
    assert one(rb"[A-Z]{5}99") == (U,) * 5 + (1 << ord("9"),) * 2
    assert one(rb"qu+x") == (1 << ord("q"), 1 << ord("u"), (1 << ord("u")) | (1 << ord("x")))
    assert one(rb"a[0-9]{2,}") == (1 << ord("a"), D, D)  # nothing follows
    assert one(rb"a[0-9]+x?y") == (1 << ord("a"), D)  # what follows can be empty
    assert one(rb"[0-9]{20}") == (D,) * 8  # cut at k
    assert A.device_class_sequences(parse(rb"a*"), 8) is None


@pytest.fixture(scope="module")
def batch():
    return compile_multi(BATCH)


def test_batch_keeps_the_compilers_routing(batch):
    """Only the patterns the compiler sent to sequences get the longer
    ones; the routing helper gives compile_multi's plan."""
    cp = batch
    routes = [pattern_route(t)[0] for t in cp.asts]
    assert [BATCH[i] for i, r in enumerate(routes) if r == "seqs"] == [
        rb"[0-9]{3}-[0-9]{4}", rb"qu+x", rb"[A-Z]{5}99"]
    assert cp.class_seqs == sorted({s for r, p in map(pattern_route, cp.asts) if r == "seqs" for s in p})
    assert sorted(len(s) for s in device_class_seqs(cp)) == [3, 7, 8]
    assert sorted(len(s) for s in cp.class_seqs) == [2, 3, 5]


def _log_text(nbytes: int) -> np.ndarray:
    with open(os.path.join(ROOT, "scanbench", "configs", "log_ioc.json")) as f:
        cfg = json.load(f)
    seed = int(cfg["text_seed"])
    return text_from_pool(np.random.default_rng([seed, 3]), pool_arrays(log_ioc.line_pool(cfg, seed)), nbytes)


def test_log_text_blocks_flagged(batch, monkeypatch):
    """On 4 MiB of the log archive's text (no indicator in it) the
    batch's device member flags under 1% of the 512-byte blocks; the
    compiler's prefix sequences in its place flag over 90%."""
    n = 4 << 20
    buf = np.zeros(n + 32 * 512, np.uint8)
    buf[:n] = _log_text(n)
    flagged = DeviceScanner(batch, buf_size=n, devices=["cpu"]).scan(buf)
    assert flagged.size == n // 512 and (flagged > 0).sum() < 0.01 * flagged.size
    monkeypatch.setattr(scan_pipeline, "device_class_seqs", lambda cp: cp.class_seqs)
    parent = DeviceScanner(batch, buf_size=n, devices=["cpu"]).scan(buf)
    assert (parent > 0).sum() > 0.9 * parent.size


TINY = dict(log_files=4, log_min_bytes=256 << 10, log_max_bytes=2 << 20, log_total_bytes=4_000_000,
            big_log_bytes=[], binary_bytes=[65536], base_bytes=4 << 20, piece_bytes=256 << 10,
            pool_lines=3000, plants_per_file=[16, 24])


@pytest.fixture(scope="module")
def sweep_tree(tmp_path_factory):
    """A small tree from log_ioc_h110's generator: its text, its literal
    and regex plants; and the plain reference's stdout of the sweep."""
    with open(os.path.join(ROOT, "scanbench", "configs", "log_ioc_h110.json")) as f:
        cfg = dict(json.load(f), **TINY)
    corpus = prepare(cfg, 2**31 + 4242, str(tmp_path_factory.mktemp("h110")))
    want = reference.tree_outputs([(corpus.root, BATCH, False)], workers=1)[0]
    return corpus, want


def _sweep(argv, cache=None, request=0):
    out, err = io.BytesIO(), io.StringIO()
    if cache is None:
        rc = port_cli.main(argv, out=out, err=err, request=request)
    else:
        rc = server_mod._run_with_cache(argv, cache, out, err, request)
    assert rc == 0, err.getvalue()
    return out.getvalue(), err.getvalue()


def test_reference_sweep_prints_regex_plants(sweep_tree):
    corpus, want = sweep_tree
    regex_plants = {t for t in corpus.planted if t.encode() not in BATCH[:100]}
    assert len(regex_plants) >= 5
    printed = [t for t in regex_plants if t.encode() in want]
    assert len(printed) >= 3
    # the capturing pattern never matches under PCRE1: a line holding its
    # plant is printed only for another pattern's match
    for ln in want.splitlines():
        if b"abcdefjkl" in ln or b"abcghijkl" in ln:
            rest = ln.replace(b"abcdefjkl", b"").replace(b"abcghijkl", b"")
            assert any(re.search(p, rest) for p in BATCH if p != rb"abc(def|ghi)jkl")


@pytest.mark.parametrize("shards", [1, 2], ids=["one device", "-n 2"])
def test_sweep_stdout_equals_reference(sweep_tree, monkeypatch, shards):
    corpus, want = sweep_tree
    monkeypatch.setenv("GRAB_TPU_TORCH_DEVICE", ",".join(["cpu"] * shards))
    argv = (["-n", str(shards)] if shards > 1 else []) + ["--stats", "-r", "-H", BATCH_FILE, corpus.root]
    out, err = _sweep(argv)
    assert out == want and out.count(b"\n") > 20
    replayed = int(re.search(r" replay_bytes=(\d+) ", err)[1])
    scanned = int(re.search(r" bytes=(\d+) ", err)[1])
    assert 0 < replayed < 0.1 * scanned
    # the factor-less regexes' class gates settle most windows without the VM
    cleared, passed = map(int, re.search(r" seqgate=(\d+)/(\d+) ", err).groups())
    assert cleared > 0.9 * (cleared + passed), (cleared, passed)


def test_sweep_through_the_server_equals_reference(sweep_tree, monkeypatch):
    """A cache miss, then a hit on the cached scanner and the cached
    compiled patterns, with the same class-gate counts."""
    corpus, want = sweep_tree
    monkeypatch.setenv("GRAB_TPU_TORCH_DEVICE", "cpu")
    cache = server_mod._EngineCache()
    argv = ["--stats", "-r", "-H", BATCH_FILE, corpus.root]
    gates = []
    for i, state in enumerate(("miss", "hit")):
        out, err = _sweep(argv, cache, request=i + 1)
        assert out == want and f"scanner={state}:" in err and f" compiled={state} " in err
        gates.append(re.search(r" seqgate=(\d+/\d+) ", err)[1])
    assert gates[0] == gates[1] != "0/0"
