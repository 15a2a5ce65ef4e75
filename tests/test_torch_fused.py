"""The port's fused literal/class-sequence ensemble against the JAX
package's, and the multi-member DeviceScanner (fused, split and
absorbed-shorts plans).

The ensemble's split (compare buckets, filter, sequences), its tables
and probes, the plain PyTorch row bitmap, the lane-OR (packed, total),
the decoded flags and DeviceScanner.scan must equal the reference's
exactly (tolerance: exact — every output is integer bits). The
reference runs its Pallas kernels in interpret mode on the CPU and its
numpy oracle. The CUDA kernel itself runs only on the card:
tests/test_torch_gpu.py and chip_smoke.py.
"""

import functools
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grab_tpu.ops import class_prefilter as ref_cp
from grab_tpu.ops import pallas_corewords as ref_cw
from grab_tpu.ops import pallas_fused as ref
from grab_tpu.regex.compiler import compile_multi as ref_compile
from grab_tpu_torch.ops import fused as port
from grab_tpu_torch.regex.compiler import compile_multi

import test_mixed_batch

LANES, PAD_ROWS, BLOCK = 128, 8, 512
N = 256 * 1024  # 512 word rows: a multiple of the reference's 256-row tile

DIGIT = sum(1 << b for b in range(48, 58))
LOWER = sum(1 << b for b in range(97, 123))
HIGH = sum(1 << b for b in range(0x80, 0xC0)) | (1 << 0xFF)


def _lits(k, lo, hi, seed, byte_lo=97, byte_hi=123):
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(byte_lo, byte_hi, size=int(rng.integers(lo, hi)), dtype=np.uint8))
            for _ in range(k)]


def _ensembles():
    """(literals, mask sequences): the shapes the engine builds."""
    one = [(DIGIT, DIGIT, DIGIT, LOWER, LOWER)]
    three = [(DIGIT,) * 5, (HIGH, DIGIT, HIGH), (DIGIT,) * 8]
    return {
        "100 long + 1 seq": (_lits(100, 7, 12, 12), one),  # the 100-literal batch
        "60 short + 40 long + 3 seqs": (_lits(60, 3, 7, 1) + _lits(40, 7, 12, 2), three),
        "1 bucket + 3 seqs": ([b"linus", b"lmnus"], three),
        "40 long + 4 short + 1 seq": (_lits(40, 9, 10, 4) + [b"qZx", b"Wk9p", b"##a##", b"zzTOPz"],
                                      one),
        "3 long + 30 short": (_lits(3, 7, 12, 3) + _lits(30, 3, 7, 5), None),
        "high bytes": (_lits(20, 3, 12, 6, 0x80, 256), [(HIGH, HIGH)]),
        "unmasked long bucket": ([b"needle%02dXY" % i for i in range(4)], one),
        "seqs only": ([], three),
        # the 100-literal + 10-regex batch as DeviceScanner builds it
        # (built in _batch4_pair)
        "batch4": None,
    }


ENSEMBLES = _ensembles()


def _words(kind: str, plants, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        buf = np.zeros(N, dtype=np.uint8)
    elif kind == "binary":
        buf = rng.integers(0, 256, size=N, dtype=np.uint8)
    else:
        buf = rng.integers(32, 127, size=N, dtype=np.uint8)
    spots = [0, 509, 32 * BLOCK - 3, 64 * BLOCK - 1, 100_001, 200_001]
    spots += [1000 + 31 * i for i in range(12)]
    spots += [r * BLOCK + 507 + d for r in (0, 77, 511) for d in range(4)]  # lane 127
    for i, pos in enumerate(spots):
        s = plants[i % len(plants)]
        pos = min(pos, N - len(s))
        buf[pos : pos + len(s)] = np.frombuffer(s, dtype=np.uint8)
    w = buf.view("<i4").reshape(-1, LANES)
    return np.concatenate([w, np.zeros((PAD_ROWS, LANES), "<i4")])


def _plants(lits):
    return list(lits[:5]) + [b"123ab", b"12345678", b"\x855\x85", b"\x80\x80"]


@functools.lru_cache(maxsize=None)
def _batch4_pair():
    """The batch's fused scanner, as both packages' DeviceScanner builds
    it: every literal of the compiled batch and its class sequences."""
    from grab_tpu_torch.ops.classseq import compile_sequences

    pats = test_mixed_batch.build()[0]
    rcp, pcp = ref_compile(pats), compile_multi(pats)
    r = ref.FusedEnsembleScanner([bytes(l) for l in rcp.literals],
                                 ref_cp.compile_sequences(rcp.class_seqs),
                                 tile_rows=256, interpret=True)
    p = port.FusedEnsembleScanner([bytes(l) for l in pcp.literals],
                                  compile_sequences(pcp.class_seqs))
    # plants: three of the sequences' and the literal factors' hits first
    return r, p, [b"555-1234", b"QWERT99", b"quuux"] + [bytes(l) for l in pcp.literals]


def _pair(name):
    if name == "batch4":
        return _batch4_pair()
    lits, masks = ENSEMBLES[name]
    rseqs = ref_cp.compile_sequences(masks) if masks else None
    from grab_tpu_torch.ops.classseq import compile_sequences

    pseqs = compile_sequences(masks) if masks else None
    return (ref.FusedEnsembleScanner(lits, rseqs, tile_rows=256, interpret=True),
            port.FusedEnsembleScanner(lits, pseqs), lits)


@pytest.mark.parametrize("name", list(ENSEMBLES))
def test_ensemble_tables_identical(name):
    r, p, _ = _pair(name)
    assert p.n_members == r.n_members
    assert p.cw_shapes == r.cw_shapes
    assert len(p.cw_tests) == len(r.cw_tests)
    for pt, rt in zip(p.cw_tests, r.cw_tests):
        assert pt.literals == rt.literals and np.array_equal(pt.tab, rt.tab)
    assert p.xor_groups == r.xor_groups
    assert (p.xor is None) == (r.xor is None)
    if p.xor:
        assert np.array_equal(p.xor.tables(), r.xor.tables())
    assert p.seqs == r.seqs
    assert (p.probe_back, p.probe_fwd) == (r.probe_back, r.probe_fwd)


@pytest.mark.parametrize("name", list(ENSEMBLES))
def test_program_layout(name):
    """The kernel's input: header, bucket heads, tables, filter."""
    _r, p, _ = _pair(name)
    prog = p.program()
    nb = len(p.cw_tests)
    assert prog.dtype == np.int32 and prog[0] == nb and prog[3] == int(bool(p.seqs))
    assert prog[2] == max([t.n_words for t in p.cw_tests] + [1]
                          + ([(6 + max(len(s) for s in p.seqs)) // 4] if p.seqs else []))
    for b, t in enumerate(p.cw_tests):
        k, w, masked, off = prog[4 + 4 * b : 8 + 4 * b]
        assert (k, w, bool(masked)) == (t.k, t.n_words, t.masked)
        assert np.array_equal(prog[off : off + t.tab.size], t.tab.reshape(-1))
    if p.xor:
        assert np.array_equal(prog[prog[1] :], p.xor.program())
    else:
        assert prog[1] == 0


@pytest.mark.parametrize("kind", ["text", "binary", "zeros"])
@pytest.mark.parametrize("name", list(ENSEMBLES))
def test_plain_bitmap_matches_reference(name, kind):
    r, p, lits = _pair(name)
    w2d = _words(kind, _plants(lits), seed=len(name))
    bm_np = ref.np_fused_bitmap(w2d, r)
    total, packed, bm = port.fused_word_flags(torch.from_numpy(w2d), p)
    assert bm.dtype == torch.int32 and bm.shape == (N // BLOCK // 32, LANES)
    assert (bm.numpy() == bm_np).all()
    tot_ref, pk_ref = ref_cw.packed_block_flags(jnp.asarray(bm_np))
    assert (packed.numpy() == np.asarray(pk_ref)).all()
    assert int(total.item()) == int(tot_ref) > 0


@pytest.mark.parametrize("name", ["100 long + 1 seq", "60 short + 40 long + 3 seqs",
                                  "1 bucket + 3 seqs", "batch4"])
def test_scanner_flags_match_reference_kernel(name):
    """Against the Pallas kernel itself (interpret mode): bitmap,
    (total, packed) and decoded flags."""
    r, p, lits = _pair(name)
    w2d = _words("text", _plants(lits), seed=3)
    assert (N // BLOCK) % r.tile_rows == 0
    rtot, rpk = r.packed(jnp.asarray(w2d))
    ptot, ppk, bm = port.fused_word_flags(torch.from_numpy(w2d), p)
    assert (bm.numpy() == np.asarray(r.bitmap(jnp.asarray(w2d)))).all()
    assert int(ptot.item()) == int(rtot) > 0
    nb = N // BLOCK
    assert (p.flags_np(ppk.numpy(), nb) == r.flags_np(np.asarray(rpk), nb)).all()


def test_wrapper_rejects_bad_input():
    _r, p, _ = _pair("1 bucket + 3 seqs")
    w = torch.zeros((64 + PAD_ROWS, LANES), dtype=torch.int32)
    for bad in (w[:, :64], w[: 40 + PAD_ROWS], w.to(torch.int64)):
        with pytest.raises(ValueError):
            port.fused_word_flags(bad, p)
    with pytest.raises(ValueError):
        port.fused_word_flags(w, port.FusedEnsembleScanner([], None))


# -- DeviceScanner, literal mode: fused, split and absorbed plans -----------

SEQ_PATS = [("[0-9]{%d}[a-z]{%d}" % (3 + i % 3, 1 + i % 2)).encode() for i in range(10)]
PLANS = {
    # the 100-literal + 10-regex batch (tests/test_mixed_batch.py)
    "mixed batch": test_mixed_batch.build()[0],
    # 10 sequence patterns + 5 literals: the union stride member beside the fused scanner
    "stride member": SEQ_PATS + [b"needle_%d" % i for i in range(5)],
    # one sequence stays inside the fused scanner
    "one sequence": [b"needle", b"linus", rb"[0-9]{3}[a-z]{2}"],
    # 40 long literals + 1 regex: filter + sequence
    "filter": _lits(40, 9, 10, 4) + [rb"[0-9]{3}[a-z]{2}"],
    # shorts that fragment the union's classes stay in compare buckets
    "shorts kept": [b"[0-9]{3}[a-z]{2}", b"[0-9]{4}[a-z]", b"qZxW", b"kV9#p"],
    # class-compatible shorts are absorbed by the stride member
    "shorts absorbed": [b"[0-9]{3}x", b"[0-9]{4}y", b"xyx", b"yxy"],
    # ... beside a fused scanner that keeps only the 7+-byte literals
    "shorts absorbed, longs kept": [b"[0-9]{3}x", b"[0-9]{4}y", b"xyx", b"yxy", b"longliteral"],
    # 20 short literals: two compare buckets
    "two buckets": [b"lit%02d" % i for i in range(20)],
    # a single member falls to the split path's one core-word scanner
    "single": [b"linus", b"lmnus"],
}
ENVS = {"default": {}, "no_fused": {"GRAB_TPU_NO_FUSED": "1"}, "no_seqdfa": {"GRAB_TPU_SEQDFA": "0"}}


def _scan_buffer(buf_size, seed=5):
    rng = np.random.default_rng(seed)
    buf = rng.integers(65, 91, size=buf_size + 32 * 512, dtype=np.uint8)
    buf[buf_size:] = 0
    lits = test_mixed_batch.build()[0]
    plants = [b"12345ab", b"999xy", b"needle_3", b"1234a", b"qZxW", b"yxy", b"123x", b"lit07", b"longliteral", b"4567y",
              b"linus", lits[0], lits[50], b"fooqqbar", b"555-1234", b"quuux", b"zzbzz"]
    for i, pos in enumerate((1000, 50_000, 100_000, buf_size // 2 - 3, buf_size - 600,
                             64 * 1024 - 2, 300_000, 400_007, 450_001, 500_000, 520_000,
                             560_000, 580_000, 700_001, 800_003)):
        for k in range(3):
            s = plants[(i + 5 * k) % len(plants)]
            at = min(pos + 40 * k, buf_size - len(s))
            buf[at : at + len(s)] = np.frombuffer(s, np.uint8)
    return buf


@pytest.mark.parametrize("env", list(ENVS))
@pytest.mark.parametrize("plan", list(PLANS))
def test_literal_plans_match_reference(monkeypatch, plan, env):
    """Same members (types, absorbed shorts, compare buckets, filter) as
    the reference DeviceScanner (Pallas interpret mode) on one 1 MiB
    buffer. The class sequences are carried past each pattern's first
    repeat (regex.compiler.device_class_seqs), so each begins with one of
    the reference's and the flags are a subset of the reference's that
    still hold every block where a pattern's match starts (Python re);
    on a clean buffer the flags are equal."""
    from grab_tpu.scan_pipeline import DeviceScanner as RefScanner
    from grab_tpu_torch.scan_pipeline import DeviceScanner

    for var in ("GRAB_TPU_NO_FUSED", "GRAB_TPU_SEQDFA"):
        monkeypatch.delenv(var, raising=False)
    for var, val in ENVS[env].items():
        monkeypatch.setenv(var, val)
    pats = PLANS[plan]
    buf_size = 1 << 20
    r = RefScanner(ref_compile(pats), buf_size=buf_size, pallas_interpret=True)
    p = DeviceScanner(compile_multi(pats), buf_size=buf_size, devices=["cpu"])
    assert r.mode == p.mode == "literal"
    assert [type(m).__name__ for m in p.members] == [type(m).__name__ for m in r._cw_list]
    assert p._shorts_absorbed == getattr(r, "_shorts_absorbed", False)
    for pm, rm in zip(p.members, r._cw_list):
        if type(pm).__name__ == "FusedEnsembleScanner":
            assert (pm.cw_shapes, pm.xor_groups, pm.n_members) == (
                rm.cw_shapes, rm.xor_groups, rm.n_members)
        if getattr(pm, "seqs", None):
            assert all(any(s[: len(q)] == q for q in rm.seqs) for s in pm.seqs)
    buf = _scan_buffer(buf_size)
    want = r.scan(buf)
    got = p.scan(buf)
    assert got.dtype == want.dtype and got.shape == want.shape and got.sum() > 0
    assert np.all((got > 0) <= (want > 0))
    starts = {m.start() // BLOCK for pat in pats
              for m in re.finditer(b"(?=" + pat + b")", buf[:buf_size].tobytes())}
    assert starts and all(got[b] > 0 for b in starts)
    if all(getattr(pm, "seqs", None) == getattr(rm, "seqs", None) for pm, rm in zip(p.members, r._cw_list)):
        assert np.array_equal(got, want)  # no sequence carried further: the reference's flags
    clean = np.zeros(buf_size, np.uint8)
    assert np.array_equal(p.scan(clean), r.scan(clean))


def test_expected_member_types(monkeypatch):
    """The plans above reach every literal-mode shape."""
    from grab_tpu_torch.scan_pipeline import DeviceScanner

    def members(plan, **env):
        for var in ("GRAB_TPU_NO_FUSED", "GRAB_TPU_SEQDFA"):
            monkeypatch.delenv(var, raising=False)
        for var, val in env.items():
            monkeypatch.setenv(var, val)
        sc = DeviceScanner(compile_multi(PLANS[plan]), buf_size=1 << 20, devices=["cpu"])
        return [type(m).__name__ for m in sc.members], sc._shorts_absorbed

    assert members("stride member") == (["FusedEnsembleScanner", "_StrideSeqMember"], False)
    assert members("stride member", GRAB_TPU_SEQDFA="0") == (["FusedEnsembleScanner"], False)
    assert members("stride member", GRAB_TPU_NO_FUSED="1") == (
        ["XorWordScanner", "_StrideSeqMember"], False)  # 5 literals of 8 bytes
    assert members("filter", GRAB_TPU_NO_FUSED="1")[0][0] == "XorWordScanner"
    assert members("shorts kept") == (["FusedEnsembleScanner", "_StrideSeqMember"], False)
    assert members("shorts absorbed") == (["_StrideSeqMember"], True)
    assert members("shorts absorbed, longs kept") == (
        ["FusedEnsembleScanner", "_StrideSeqMember"], True)
    assert members("two buckets") == (["FusedEnsembleScanner"], False)
    assert members("two buckets", GRAB_TPU_NO_FUSED="1") == (["CoreWordScanner"] * 2, False)
    assert members("single") == (["CoreWordScanner"], False)
    got, _ = members("mixed batch", GRAB_TPU_NO_FUSED="1")
    assert got[0] == "XorWordScanner" and "CoreWordScanner" in got
