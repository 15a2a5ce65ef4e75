"""The port's pattern compiler against the JAX package's.

Every CompiledPattern field except the ``matchers`` objects must be
equal (exact): ASTs by structure, the DFAs by table, class map, accept
mask, accept ids and start state, and the literal / class-sequence /
class-run plans. Patterns that fail to compile must fail the same way.
A subprocess in which ``import jax`` fails must import the port, compile
and scan on the CPU without loading anything of grab_tpu.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from grab_tpu.regex.compiler import compile_multi as ref_compile
from grab_tpu_torch.regex.compiler import compile_multi as port_compile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_regex_parser.py
PARSER_PATTERNS = [
    b"abc", b".", b"[a-cx]", b"[^a]", b"[]a]", b"[a-]", b"[[:digit:]x]",
    rb"\n", rb"\x41", rb"\x{7f}", rb"\.", rb"\d", rb"\W", rb"\cA",
    b"a{2,5}", b"a{3}", b"a{2,}", b"a+?", b"a{,5}", b"ab|cd|(?:e)",
    b"(a)(b)", b"^foo$", rb"\bx", rb"\Qa.c\E!", b"foo[a-z]+bar", b"a|bc",
    b"^x?$", b"a{2,5}b", b"a+", b"a(b)c", b"a(?:b)c", rb"(a)\1", b"foobar",
    b"abc|xyz", b"[a-z]+", b"ab(cd)+ef", b"colou?r", b"a*b*",
    # syntax errors: both compilers must refuse alike
    b"(a", b"a**", b"[a", b"(?(1)a|b|c)", b"(?(R2)a|b)", b"(?5)(a)",
    b"\\p{Nope}", b"\\k<nope>ab",
]
# tests/test_alpharun.py
ALPHA_PATTERNS = [
    rb"[0-9]{10}", rb".{0,2}[0-9]{10}", rb"[0-9]{8}x|y[0-9]{4}",
    rb"([0-9]+)?x", rb"([0-9]{2}){3}", rb"[0-9]{3}[a-z]{2}",
    rb"([0-9]{6})\1", rb"(?=[a-z])[0-9]{5}", rb"[a-zA-Z]", rb"[0-9]{8}",
    rb".{0,2}[0-9]{11}",
]
# tests/test_conformance.py CASES, and the benchmark configurations
CONFORMANCE_PATTERNS = [
    rb"needle", rb"ne+dle", rb"n[a-z]+e", rb"zzznotfound", rb"\bneedle\b",
    b"linus", b"l[imn]nus", b"needleXY", b"zQx##missing##",
]
# tests/test_lookaround_flags.py: lookaround, inline flags, named groups
LOOKAROUND_PATTERNS = [
    rb"(?=fo)f.o", rb"foo(?!bar)", rb"(?<=a)b+", rb"(?<!a)b+", rb"(?i)fook", rb"(?i:fo)ok",
    rb"(?s)a.b", rb"(?m)^boq", rb"(?m)coq$", rb"(?P<g>aqz)x\k<g>", rb"(?x) a q z # comment",
    rb"(?i)[a-f]{3}q", rb"\w+(?=;)",
]
# tests/test_pcre_surface.py: \p{..}, conditionals, caseless backreferences,
# subroutine calls and recursion
PCRE_PATTERNS = [
    rb"\p{Lu}\p{Ll}+\p{Nd}", rb"\p{Greek}", rb"(?i)\p{Lu}", rb"(?i)[\p{Lu}x]",
    rb"(a)?(?(1)b|c)x", rb"(?<g>\d)?(?(<g>)\.\d|Z)", rb"(?(?=\d)\d\d|[a-z]z)9",
    rb"(?i)([a-d]{2})\1", rb"(?i)x([mn])-\1", rb"\((?:[^()]|(?R))*\)", rb"([0-9]{2})-(?1)",
    rb"(?(DEFINE)(?<oct>25[0-5]|2[0-4][0-9]|[01]?[0-9][0-9]?))(?&oct)\.(?&oct)",
    rb"(?2)x(q)(ab|cd)", rb"((?(R1)b|a)(?1)?)", rb"\p{NotAScript}",
]
SINGLE = [(p, False) for p in PARSER_PATTERNS + ALPHA_PATTERNS + CONFORMANCE_PATTERNS
          + LOOKAROUND_PATTERNS + PCRE_PATTERNS]
SINGLE += [(p, True) for p in (b"needleXY", b"a.b*c", b"\x80\xff\x00z", b"ab")]
BATCHES = [
    [b"needle", b"linus", b"foo[a-z]+bar"],
    [b"abc", b"xyz", b"[0-9]{10}"],
    [b"lit%02d" % i for i in range(20)],
    [b"longliteral%02d" % i for i in range(6)],
    [b"needle", b"a(b)c"],
]


def _norm(v):
    if dataclasses.is_dataclass(v) and type(v).__name__ == "DFA":
        return (
            "DFA",
            v.table.dtype.str, v.table.tolist(), v.class_map.tolist(),
            v.accept_mask.tolist(), [sorted(p) for p in v.accept_pids], v.start,
        )
    if isinstance(v, np.ndarray):
        return (v.dtype.str, v.tolist())
    if isinstance(v, (list, tuple)):
        return type(v).__name__, [_norm(x) for x in v]
    if hasattr(v, "__dataclass_fields__"):  # AST nodes: structure by repr
        return repr(v)
    return v


def _snapshot(cp):
    return {
        f.name: _norm(getattr(cp, f.name))
        for f in dataclasses.fields(cp)
        if f.name != "matchers"
    }


def _compile(fn, pats, literal_mode):
    try:
        return _snapshot(fn(pats, literal_mode=literal_mode))
    except Exception as e:  # compile errors must match too
        return ("raised", type(e).__name__, str(e))


@pytest.mark.parametrize(
    "pattern,literal_mode", SINGLE, ids=[f"{p!r}-S{int(l)}" for p, l in SINGLE]
)
def test_compiled_pattern_equal(pattern, literal_mode):
    want = _compile(ref_compile, [pattern], literal_mode)
    got = _compile(port_compile, [pattern], literal_mode)
    assert got == want


def _latin1ish(A):
    """The synthetic Latin-1 LC_CTYPE of tests/test_locale_tables.py:
    accented letters are alpha and word, NBSP is space."""
    t = {
        "isalpha": A.ALPHA_MASK, "isdigit": A.DIGIT_MASK, "isalnum": A.ALNUM_MASK,
        "isspace": A.SPACE_MASK | (1 << 0xA0), "isupper": A.UPPER_MASK,
        "islower": A.LOWER_MASK,
    }
    for b in (0xE9, 0xE8, 0xC9, 0xFC):
        t["isalpha"] |= 1 << b
        t["isalnum"] |= 1 << b
    t["word"] = t["isalnum"] | (1 << 0x5F)
    return t


@pytest.mark.parametrize("pattern", [rb"\w+", rb"[[:alpha:]]+x", rb"\s\S+", rb"\bcaf\w\b"],
                         ids=repr)
def test_compiled_pattern_equal_in_latin1_locale(pattern):
    """A non-C LC_CTYPE table set in both packages: class escapes, POSIX
    classes and \\b compile alike, field for field."""
    from grab_tpu.regex import ast as ref_ast
    from grab_tpu.regex import ctype as ref_ctype
    from grab_tpu_torch.regex import ast as port_ast
    from grab_tpu_torch.regex import ctype as port_ctype

    ref_ctype.set_tables(_latin1ish(ref_ast))
    port_ctype.set_tables(_latin1ish(port_ast))
    try:
        want = _compile(ref_compile, [pattern], False)
        got = _compile(port_compile, [pattern], False)
    finally:
        ref_ctype.set_tables(None)
        port_ctype.set_tables(None)
    assert got == want
    c_locale = _compile(port_compile, [pattern], False)
    assert c_locale != got  # the table changed what compiled


@pytest.mark.parametrize("batch", BATCHES, ids=[f"batch{i}" for i in range(len(BATCHES))])
def test_compiled_batch_equal(batch):
    assert _compile(port_compile, batch, False) == _compile(ref_compile, batch, False)


@pytest.mark.parametrize(
    "pattern", [p for p, lit in SINGLE if not lit], ids=lambda p: repr(p)
)
def test_stride_plan_equal(pattern):
    """The -E device/host decision: the port's strided-DFA planner
    picks the reference's plan (or None) for the same automaton."""
    from grab_tpu.ops.pallas_stridedfa import stride_plan as ref_plan
    from grab_tpu_torch.ops.stridedfa import stride_plan as port_plan

    try:
        want = ref_plan(ref_compile([pattern]).dfa)
    except Exception as e:
        want = ("raised", type(e).__name__)
    try:
        got = port_plan(port_compile([pattern]).dfa)
    except Exception as e:
        got = ("raised", type(e).__name__)
    assert got == want


def test_port_runs_where_jax_cannot_import(tmp_path):
    code = r"""
import sys
sys.modules["jax"] = None
import grab_tpu_torch.cli
from grab_tpu_torch.engine import Engine, EngineConfig
from grab_tpu_torch.regex.compiler import compile_multi

cp = compile_multi([rb".{0,2}[0-9]{11}"])  # uncovered: the class-run planner
assert cp.alpha_plan is not None and not cp.covered
out = []
eng = Engine(b"needle", EngineConfig(device="cpu"))
eng.scan_data("f", b"abc needle xyz\n" * 1000, out.append)
assert b"".join(out).count(b"needle") >= 1, out
import grab_tpu_torch.ops.alpharun, grab_tpu_torch.ops.dfa_scan
import grab_tpu_torch.ops.fused, grab_tpu_torch.ops.xorfilter
pats = [b"longliteral%02d" % i for i in range(6)] + [b"needle", rb"[0-9]{3}[a-z]{2}"]
for p in (pats, [rb".{0,2}[0-9]{11}"]):
    out = []
    eng = Engine(p, EngineConfig(device="cpu"))
    eng.scan_data("f", b"abc longliteral03 needle 123ab x91827364550x\n" * 500, out.append)
    assert out, p
import grab_tpu_torch.ops.bloom, grab_tpu_torch.parallel.scan_step
import grab_tpu_torch.parallel.runner, grab_tpu_torch.server
import numpy as np, torch
sc = grab_tpu_torch.ops.bloom.BloomWordScanner([b"needleXY", b"longliteral03"])
words = np.zeros((40, 128), "<i4")
words.reshape(-1).view(np.uint8)[1001:1009] = np.frombuffer(b"needleXY", np.uint8)
total, packed = sc.packed(torch.from_numpy(words))
assert int(total) == 1 and sc.flags_np(packed.numpy(), 32)[1] == 1
out = []
eng = Engine(b"needle", EngineConfig(device="cpu,cpu", n_shards=2, scan_buf_size=64 << 10))
sc = eng._get_scanner()
assert type(sc).__name__ == "DeviceScanner" and len(sc.lanes) == 2
eng.scan_data("f", b"abc needle xyz\n" * 20000, out.append)
assert b"".join(out).count(b"needle") >= 20000, len(out)
cache = grab_tpu_torch.server._EngineCache()
e1 = cache.engine_for([b"needle"], EngineConfig(device="cpu"))
assert cache.engine_for([b"needle"], EngineConfig(device="cpu"))._scanner is e1._scanner
import grab_tpu_torch.parallel.hostrun, grab_tpu_torch.spot, grab_tpu_torch.ops.class_prefilter
from grab_tpu_torch import golden
from grab_tpu_torch.ops.literal_scan import literal_matrix, literal_scan_bitmap
from grab_tpu_torch.parallel.multihost import merge_host_outputs
import os, tempfile
with tempfile.TemporaryDirectory() as d:
    for name, body in (("1.3.out", b"c"), ("0.0.out", b"a"), ("0.2.out", b"b")):
        with open(os.path.join(d, name), "wb") as f:
            f.write(body)
    got = []
    assert merge_host_outputs(d, got.append) == 3 and got == [b"a", b"b", b"c"]
assert golden.block_counts(np.array([1, 0, 1, 1], bool), 2).tolist() == [1, 2]
import io
import grab_tpu_torch.bench
from grab_tpu_torch import dryrun
fn, args = dryrun.entry("cpu")
assert tuple(int(x) for x in fn(*args)) == (1, 2)
res = dryrun.dryrun_multichip(2, "cpu,cpu", out=io.StringIO())
assert res["engine"]["lines"] > 0 and res["word_scan"]["total"] >= 2, res
mat, lens = literal_matrix([b"needle"])
hits = literal_scan_bitmap(mat, tuple(lens.tolist()), torch.frombuffer(bytearray(b"a needle"), dtype=torch.uint8))
assert hits.nonzero().flatten().tolist() == [2]
leaked = [m for m in sys.modules
          if m.split(".")[0] == "grab_tpu" or (m.split(".")[0] == "jax" and sys.modules[m] is not None)]
assert not leaked, leaked
print("PORT_OK")
"""
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    assert b"PORT_OK" in r.stdout
