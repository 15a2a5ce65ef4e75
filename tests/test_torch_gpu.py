"""Tests that need a CUDA card: the hand-written kernels against their
plain PyTorch versions (exact: every output is integer bits).

They skip on a machine without a card. This file imports nothing of
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

(chip_smoke.py runs the same check at the main path's full 32 MiB
geometry.)
"""

import ctypes

import numpy as np
import pytest
import torch

from grab_tpu_torch.ops import corewords as cw

LANES, PAD_ROWS, BLOCK = 128, 8, 512
N = 256 * 1024  # 512 word rows: 16 bitmap groups


def _literal_sets():
    rng = np.random.default_rng(16)
    k16 = []
    for i, n in enumerate([3, 4, 5, 6, 3, 4, 5, 6, 3, 4, 5, 6, 7, 11, 16, 20]):
        lo, hi = (0x80, 256) if i % 3 == 0 else (0x41, 0x7B)
        k16.append(bytes(rng.integers(lo, hi, size=n, dtype="u1").tolist()))
    return [
        [b"linus"],
        [b"needleXY"],
        [b"linus", b"lmnus", b"lnnus"],
        [b"abcde", b"fghij"],
        [b"\x80\xff\x81", b"\xfe\xfd\xfc\xfb\xfa\xf9\xf8"],
        [b"needle%02dXY" % i for i in range(8)],  # K=8, unmasked
        k16,
    ]


def _words(kind: str, lits, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        buf = np.zeros(N, dtype=np.uint8)
    elif kind == "binary":
        buf = rng.integers(0, 256, size=N, dtype=np.uint8)
    else:
        buf = rng.integers(32, 127, size=N, dtype=np.uint8)
    spots = [0, 509, 32 * BLOCK - 3, 64 * BLOCK - 1, 100_001]
    spots += [r * BLOCK + 507 + d for r in (0, 77, 511) for d in range(4)]
    for i, pos in enumerate(spots):
        lit = lits[i % len(lits)]
        pos = min(pos, N - len(lit))
        buf[pos : pos + len(lit)] = np.frombuffer(lit, dtype=np.uint8)
    w = buf.view("<i4").reshape(-1, LANES)
    return np.concatenate([w, np.zeros((PAD_ROWS, LANES), "<i4")])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["text", "binary", "zeros"])
def test_core_word_kernel_matches_plain(cuda, kind):
    for lits in _literal_sets():
        t = cw.CoreWordTests(lits)
        w = torch.from_numpy(_words(kind, lits, len(lits))).to(cuda)
        before = cw.core_word_flags.launches
        got = cw.core_word_flags(w, t.tab, t.k, t.n_words, t.masked)
        assert cw.core_word_flags.launches == before + 1
        bm = cw.core_word_bitmap_torch(w, t.tab, t.k, t.n_words, t.masked)
        want = cw.packed_block_flags(bm) + (bm,)
        torch.cuda.synchronize()
        for g, x in zip(got, want):
            assert g.dtype == x.dtype and torch.equal(g, x)
        assert int(got[0].item()) > 0


@pytest.mark.gpu
def test_core_word_wrapper_refuses_bad_input_on_card(cuda):
    t = cw.CoreWordTests([b"linus"])
    w = torch.zeros((64 + PAD_ROWS, LANES), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # 64 lanes
        cw.core_word_flags(w[:, ::2], t.tab, t.k, t.n_words, t.masked)
    with pytest.raises(ValueError):  # not contiguous
        cw.core_word_flags(w.t().contiguous().t(), t.tab, t.k, t.n_words, t.masked)
    with pytest.raises(ValueError):  # table shape does not match k
        cw.core_word_flags(w, t.tab, 2, t.n_words, t.masked)


@pytest.mark.gpu
def test_device_scanner_pipelined_flags_match_cpu(cuda):
    """Two batches in flight, as CorpusPipeline keeps them: each
    resolve reads its own batch's count (pinned copy + event) and the
    flags equal the CPU scanner's on the same buffers."""
    from grab_tpu_torch.regex.compiler import compile_multi
    from grab_tpu_torch.scan_pipeline import DeviceScanner, release_lanes, take_lanes

    buf = N
    cp = compile_multi([b"l[imn]nus"])
    dev = DeviceScanner(cp, buf_size=buf, devices=["cuda"])
    cpu = DeviceScanner(cp, buf_size=buf, devices=["cpu"])
    lits = [b"linus", b"lmnus", b"lnnus"]
    bufs = [_words(kind, lits, s).view(np.uint8).reshape(-1)
            for s, kind in enumerate(["text", "zeros", "binary", "text"])]
    bufs[1][:] = 0  # a clean batch: resolved from the count alone
    lanes = take_lanes(dev.lanes)
    pending = dev.submit(lanes, bufs[:1])
    got = []
    for b in bufs[1:]:
        pending += dev.submit(lanes, [b])
        got.append(dev.resolve(pending.pop(0)))
    got.append(dev.resolve(pending.pop(0)))
    release_lanes(lanes)
    for g, b in zip(got, bufs):
        want = cpu.scan(b)
        assert g.dtype == want.dtype and (g == want).all()
    assert not got[1].any() and got[0].any() and got[3].any()


# -- class-sequence (B4) and strided-DFA (B2) kernels -------------------------

HIGH = sum(1 << b for b in range(0x80, 0xC0)) | (1 << 0xFF)
DIGIT = sum(1 << b for b in range(48, 58))


def _seq_sets():
    from grab_tpu_torch.ops.classseq import compile_sequences

    rng = np.random.default_rng(32)
    many = []
    for i in range(32):
        seq = []
        for j in range(1 + i % 8):
            lo = int(rng.integers(0, 250))
            m = sum(1 << b for b in range(lo, lo + 1 + int(rng.integers(0, 6))))
            seq.append(m | (HIGH if (i + j) % 5 == 0 else 0))
        many.append(tuple(seq))
    eight = [tuple([DIGIT] * (1 + i)) for i in range(7)] + [(HIGH, DIGIT, HIGH)]
    return [compile_sequences(s) for s in ([(DIGIT,) * 5], eight, many)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["text", "binary", "zeros"])
def test_classseq_kernel_matches_plain(cuda, kind):
    from grab_tpu_torch.ops import classseq as cs

    for i, seqs in enumerate(_seq_sets()):
        w = torch.from_numpy(_words(kind, [b"12345", b"\x80" + b"7" * 8], i)).to(cuda)
        before = cs.classseq_flags.launches
        got = cs.classseq_flags(w, seqs)
        assert cs.classseq_flags.launches == before + 1
        bm = cs.classseq_bitmap_torch(w, seqs)
        want = cw.packed_block_flags(bm) + (bm,)
        torch.cuda.synchronize()
        for g, x in zip(got, want):
            assert g.dtype == x.dtype and torch.equal(g, x)
        assert int(got[0].item()) > 0


STRIDE_PATTERNS = [
    rb"[0-9]{5}", rb"[0-9a-f]{4}", rb"needle|[a-z]{3}[0-9]{3}", rb"[acegikmoqsuwy]{3}",
    rb"[adgjmpsvy]{3}", rb".{0,2}[a-z ]{11,}", rb"[0-9]{200}", rb"[0-9]{1500}",
]


def _stride_words(seed: int, n_words: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"0123456789abcdefgxyz acegikmoqsuwy \n-AZ\x80\xff", np.uint8)
    raw = rng.choice(alpha, size=(n_words * 128, LANES, 4))
    return np.ascontiguousarray(raw).view("<i4").reshape(n_words * 128, LANES)


@pytest.mark.gpu
@pytest.mark.parametrize("n_words", [8, 40, 512])
def test_stride_walk_matches_plain(cuda, n_words):
    from grab_tpu_torch.ops import stridedfa as sd
    from grab_tpu_torch.regex.compiler import compile_multi

    rng = np.random.default_rng(n_words)
    for pat in STRIDE_PATTERNS:
        dfa = compile_multi([pat]).dfa
        t = sd.StrideDfaTables(dfa, sd.stride_plan(dfa))
        w = torch.from_numpy(_stride_words(n_words, n_words)).to(cuda)
        for ent in (np.full((128, LANES), t.start, np.int32),
                    rng.integers(0, t.n_states, (128, LANES), dtype=np.int32)):
            e = torch.from_numpy(ent).to(cuda)
            before = sd.stride_dfa_scan.launches
            bm, ex = sd.stride_dfa_scan(w, t, e)
            assert sd.stride_dfa_scan.launches == before + 1
            bm_p, ex_p = sd.stride_dfa_scan_torch(w, t, e)
            torch.cuda.synchronize()
            assert torch.equal(bm, bm_p) and torch.equal(ex, ex_p), (pat, t.mode, t.k)


def _nosync_words(s_w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    raw = rng.choice(np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8), size=(128 * LANES, 4 * s_w))
    raw[:, 0] = ord("Q")
    lin = np.ascontiguousarray(raw).reshape(-1).view("<i4").reshape(128 * LANES, s_w)
    return np.ascontiguousarray(lin.T).reshape(s_w * 128, LANES)


@pytest.mark.gpu
@pytest.mark.parametrize("s_w", [5, 77, 512])
def test_stride_walk_non_synchronising_matches_plain(cuda, s_w):
    """Q(?:[a-z]{2})*Q over one Q per stream: every segment's guess is
    wrong and the fix-up re-walks it, yet (bm, exits) equal the plain
    walk's, at word-step counts that are and are not a multiple of the
    segment count."""
    from grab_tpu_torch.ops import stridedfa as sd
    from grab_tpu_torch.regex.compiler import compile_multi

    dfa = compile_multi([rb"Q(?:[a-z]{2})*Q"]).dfa
    t = sd.StrideDfaTables(dfa, sd.stride_plan(dfa))
    w = torch.from_numpy(_nosync_words(s_w, s_w)).to(cuda)
    rng = np.random.default_rng(s_w)
    for ent in (np.full((128, LANES), t.start, np.int32),
                rng.integers(0, t.n_states, (128, LANES), dtype=np.int32)):
        e = torch.from_numpy(ent).to(cuda)
        sd.fixup_words(cuda, reset=True)
        bm, ex = sd.stride_dfa_scan(w, t, e)
        rewalked = sd.fixup_words(cuda, reset=True)
        bm_p, ex_p = sd.stride_dfa_scan_torch(w, t, e)
        torch.cuda.synchronize()
        assert torch.equal(bm, bm_p) and torch.equal(ex, ex_p)
        seg = sd.segment_geometry(s_w)[0]
        assert rewalked > 0 or s_w <= sd.WARM + seg


@pytest.mark.gpu
def test_stride_fixpoint_scratch_geometry(cuda):
    """The kernel's checkpoint scratch size is segment_geometry's, and a
    fixpoint launch with a shorter scratch is refused."""
    from grab_tpu_torch.ops import stridedfa as sd
    from grab_tpu_torch.regex.compiler import compile_multi

    lib = sd._kernel_lib()
    for s_w in (1, 5, 32, 77, 512, 513, 1024):
        assert lib.gt_stride_ckpt_words(s_w) == sd.segment_geometry(s_w)[3]
    dfa = compile_multi([rb"a[0-9]*b"]).dfa
    t = sd.StrideDfaTables(dfa, sd.stride_plan(dfa))
    w = torch.from_numpy(_stride_words(1, 32)).to(cuda)
    need = sd.segment_geometry(32)[3]
    ckpt = torch.empty(need - 1, dtype=torch.int32, device=cuda)
    out = [torch.empty(n, dtype=torch.int32, device=cuda) for n in (128 * LANES, 32 * 8 * LANES,
                                                                    128 * LANES, 4)]
    counter = torch.zeros(1, dtype=torch.int64, device=cuda)
    grid = ctypes.c_int(0)
    err = lib.gt_stride_fixpoint(*sd._launch_args(w, t, 32), 24, out[0].data_ptr(),
                                 ckpt.data_ptr(), ckpt.numel(), out[1].data_ptr(),
                                 out[2].data_ptr(), out[3].data_ptr(), counter.data_ptr(), 0,
                                 ctypes.byref(grid), *sd._dev_tail(cuda))
    assert err != 0 and grid.value == 0


@pytest.mark.gpu
@pytest.mark.parametrize("max_rounds", [24, 2, 1])
@pytest.mark.parametrize("max_blocks", [0, 100, 1])
def test_stride_fixpoint_matches_plain(cuda, monkeypatch, max_rounds, max_blocks):
    """Threading across streams: ONE fixpoint launch (no walk launch)
    whatever MAX_ROUNDS is; walks run, convergence and the bitmap (all
    ones at the round cap) equal the plain loop's, also with the grid
    capped below 256 blocks (each block walks several stream tiles)."""
    from grab_tpu_torch.ops import stridedfa as sd
    from grab_tpu_torch.regex.compiler import compile_multi

    monkeypatch.setattr(sd, "MAX_ROUNDS", max_rounds)
    cp = compile_multi([rb"a[0-9]*b"])
    sc = sd.StrideDfaScanner(cp.dfa, cp.max_len, 2 << 20)  # stride 128 B
    buf = np.full(2 << 20, ord(" "), dtype=np.uint8)
    for start, end in ((50, 77), (1000, 1700), (300_000, 300_050)):
        buf[start] = ord("a")
        buf[start + 1 : end] = ord("7")
        buf[end] = ord("b")
    w = torch.from_numpy(sc.prep_t(buf))
    bm_p, n_p, conv_p = sd.stride_fixpoint_torch(w, sc.tables, max_rounds)
    walks, fixpoints = sd.stride_dfa_scan.launches, sd.stride_dfa_fixpoint.launches
    wd = w.to(cuda)
    bm, n, conv = (sd.stride_dfa_fixpoint(wd, sc.tables, max_blocks=max_blocks) if max_blocks
                   else sc.run_t(wd))
    assert sd.stride_dfa_scan.launches == walks
    assert sd.stride_dfa_fixpoint.launches == fixpoints + 1
    assert sd.stride_dfa_fixpoint.grid == (max_blocks or sd.stride_dfa_fixpoint.grid) > 0
    torch.cuda.synchronize()
    assert (int(n), bool(conv)) == (n_p, conv_p)
    assert torch.equal(bm.cpu(), bm_p)
    assert conv_p == (max_rounds == 24) and n_p <= max_rounds


@pytest.mark.gpu
def test_stride_fixpoint_non_synchronising_matches_plain(cuda):
    """Q(?:[a-z]{2})*Q over one Q per stream at 8 MiB: every guess of
    every walk is wrong; one fixpoint launch still gives the plain
    loop's (bm, walks, converged), twice in a row (the kernel leaves
    its round words as the next call needs them)."""
    from grab_tpu_torch.ops import stridedfa as sd
    from grab_tpu_torch.regex.compiler import compile_multi

    dfa = compile_multi([rb"Q(?:[a-z]{2})*Q"]).dfa
    t = sd.StrideDfaTables(dfa, sd.stride_plan(dfa))
    w = torch.from_numpy(_nosync_words(128, 3))
    bm_p, n_p, conv_p = sd.stride_fixpoint_torch(w, t, sd.MAX_ROUNDS)
    wd = w.to(cuda)
    for _ in range(2):
        before = sd.stride_dfa_fixpoint.launches
        bm, n, conv = sd.stride_dfa_fixpoint(wd, t)
        assert sd.stride_dfa_fixpoint.launches == before + 1
        torch.cuda.synchronize()
        assert (int(n), bool(conv)) == (n_p, conv_p) and torch.equal(bm.cpu(), bm_p)


def _text_literals(k: int, seed: int, lead: bytes = b""):
    rng = np.random.default_rng(seed)
    lits = [lead + bytes(rng.integers(33, 127, size=int(rng.integers(1 if lead else 3, 10)),
                                      dtype="u1")) for _ in range(k + k // 3)]
    return list(dict.fromkeys(lits))[:k]


LITERAL_CASES = {  # 1-, 3-, 8- and 11-byte literals, a zero-length and NUL-ending ones
    "K1": [b"fooxyzzbar"],
    "K5": [b"", b"q", b"ab\x00", b"xyz\x00\x00", b"needle-in-a"],  # the most the SWAR form takes
    "K16": [b"q", b"fox", b"abcdefgh", b"needle-in-a", b"", b"ab\x00", b"xyz\x00\x00",
            b"\x00\x00\x00"] + [b"lit%02d-xy" % i for i in range(8)],
    "K300": [b"k%03d" % i + b"xyzw"[: i % 5] for i in range(300)],
    "K1000": _text_literals(1000, 1000),
    "K3000": _text_literals(3000, 3000),  # a 64 KiB table: buckets read from global memory
    "dense": _text_literals(300, 300, b"ab"),  # 300 literals that share their first two bytes
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(LITERAL_CASES))
def test_literal_block_counts_kernel_matches_plain(cuda, case):
    """W2 (csrc/literal_scan.cu, one launch) == the plain scan and block
    counts on the card at 32 MiB, in every form that takes the keys
    (forced by form=): planted literals across block edges, NUL bytes
    (the zero-length literal's hits), a hit in the shard's last bytes
    against the zero tail; "dense": text whose every 4 bytes start with
    the 300 literals' shared pair."""
    from grab_tpu_torch.ops import literal_scan as ls

    lits = LITERAL_CASES[case]
    n = 32 << 20
    rng = np.random.default_rng(len(lits))
    buf = rng.integers(32, 127, size=n, dtype=np.uint8)
    buf[rng.integers(0, n, size=500)] = 0
    if case == "dense":
        buf[0::4], buf[1::4] = ord("a"), ord("b")
    for i in range(600):
        lit = lits[i % len(lits)]
        pos = int(rng.integers(0, n - 16)) if i % 2 else BLOCK * (i + 1) - len(lit) // 2
        buf[pos : pos + len(lit)] = np.frombuffer(lit, dtype=np.uint8)
    tail = b"ab" if case in ("K5", "K16") else lits[-1]
    buf[n - len(tail) :] = np.frombuffer(tail, dtype=np.uint8)
    keys = ls.LiteralKeys(lits)
    data = torch.from_numpy(buf).to(cuda)
    want = ls.literal_block_counts_torch(data, keys, BLOCK)
    forms = ["table"] + (["swar"] if len(lits) <= ls.SWAR_MAX else [])
    for form in forms:
        before = ls.literal_block_counts.launches
        got = ls.literal_block_counts(data, keys, BLOCK, form=form)
        assert ls.literal_block_counts.launches == before + 1
        assert ls.literal_block_counts.form == form
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and torch.equal(got, want), form
    assert int(want[-1]) > 0 and int(want.sum()) >= 600


@pytest.mark.gpu
@pytest.mark.parametrize("block", [1024, 4096])
def test_literal_block_counts_kernel_wider_blocks(cuda, block):
    """Blocks of several 512-byte chunks (a warp sums them) == the plain
    counts, on 2 MiB plus one block with literals across chunk edges."""
    from grab_tpu_torch.ops import literal_scan as ls

    lits = LITERAL_CASES["K16"]
    n = (2 << 20) + block
    rng = np.random.default_rng(block)
    buf = rng.integers(32, 127, size=n, dtype=np.uint8)
    buf[rng.integers(0, n, size=300)] = 0
    for i in range(400):
        lit = lits[i % len(lits)]
        pos = 512 * (i + 1) - len(lit) // 2 if i % 2 else int(rng.integers(0, n - 16))
        buf[pos : pos + len(lit)] = np.frombuffer(lit, dtype=np.uint8)
    keys = ls.LiteralKeys(lits)
    data = torch.from_numpy(buf).to(cuda)
    got = ls.literal_block_counts(data, keys, block)
    want = ls.literal_block_counts_torch(data, keys, block)
    swar_keys = ls.LiteralKeys(LITERAL_CASES["K5"])
    got5 = ls.literal_block_counts(data, swar_keys, block, form="swar")
    want5 = ls.literal_block_counts_torch(data, swar_keys, block)
    torch.cuda.synchronize()
    assert got.shape == (n // block,) and torch.equal(got, want) and int(want.sum()) > 400
    assert torch.equal(got5, want5) and int(want5.sum()) > 300


@pytest.mark.gpu
def test_literal_block_counts_refuses_bad_input_on_card(cuda):
    from grab_tpu_torch.ops import literal_scan as ls

    keys = ls.LiteralKeys([b"foo"])
    buf = torch.zeros(4096 + 16, dtype=torch.uint8, device=cuda)
    before = ls.literal_block_counts.launches
    with pytest.raises(ValueError):  # not 16-byte aligned
        ls.literal_block_counts(buf[1 : 1 + 4096], keys, BLOCK)
    with pytest.raises(ValueError):  # a block the kernel does not take
        ls.literal_block_counts(buf[:4096], keys, 256)
    with pytest.raises(ValueError):  # 16 keys: more than the SWAR form takes
        ls.literal_block_counts(buf[:4096], ls.LiteralKeys(LITERAL_CASES["K16"]), BLOCK,
                                form="swar")
    assert ls.literal_block_counts.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", [rb"[A-Z]{6}[0-9]{6}", rb"\t[0-9]+\t",
                                     rb".{0,2}[a-z ]{11}", rb".{0,2}(?:[0-9a-zA-Z]{4})+"])
def test_device_scanner_new_routes_match_cpu(cuda, pattern):
    """class_seq (stride member, word kernel) and gdfa (windows,
    threading), two batches in flight: flags equal the CPU scanner's."""
    from grab_tpu_torch.regex.compiler import compile_multi
    from grab_tpu_torch.scan_pipeline import DeviceScanner, release_lanes, take_lanes

    buf_size = 2 << 20
    cp = compile_multi([pattern])
    dev = DeviceScanner(cp, buf_size=buf_size, devices=["cuda"])
    cpu = DeviceScanner(cp, buf_size=buf_size, devices=["cpu"])
    assert dev.mode == cpu.mode and type(dev.members[0]) is type(cpu.members[0])
    rng = np.random.default_rng(9)
    bufs = []
    for i in range(4):
        b = rng.choice(np.frombuffer(b" -_=+()\nabcxyz", np.uint8), size=buf_size + 4096)
        b[buf_size:] = 0
        for pos in (100 + i, 4093, buf_size // 3, buf_size - 40):
            for k, s in enumerate((b"QWERTY123456", b"\t42\t", b"abc def ghij", b"a1B2c3D4e5")):
                b[pos + 13 * k : pos + 13 * k + len(s)] = np.frombuffer(s, np.uint8)
        bufs.append(b)
    bufs[1][:] = 0
    lanes = take_lanes(dev.lanes)
    pending = dev.submit(lanes, bufs[:1])
    got = []
    for b in bufs[1:]:
        pending += dev.submit(lanes, [b])
        got.append(dev.resolve(pending.pop(0)))
    got.append(dev.resolve(pending.pop(0)))
    release_lanes(lanes)
    for g, b in zip(got, bufs):
        want = cpu.scan(b)
        assert g.dtype == want.dtype and (g == want).all()
    assert got[0].any() and not got[1].any()


# -- alphabet-run (B3), XOR-filter (B5) and fused ensemble (B6) kernels -------


def _run_words(kind: str, ranges, seed: int) -> np.ndarray:
    """_words with runs of member bytes across row, group and buffer-end
    boundaries."""
    rng = np.random.default_rng(seed)
    pool = np.concatenate([np.arange(lo, hi + 1) for lo, hi in ranges]).astype(np.uint8)
    w = _words(kind, [b":;<"], seed)
    buf = w[: N // BLOCK].view(np.uint8).reshape(-1)
    for pos, ln in [(3, 60), (517, 12), (1025, 7), (2048, 5), (4999, 3), (6000, 2),
                    (9003, 1), (BLOCK - 9, 40), (32 * BLOCK - 17, 36), (64 * BLOCK - 2, 9),
                    (N - 33, 33), (N - 3, 3)]:
        buf[pos : pos + ln] = rng.choice(pool, size=ln)
    return w


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["text", "binary", "zeros"])
def test_alpharun_kernel_matches_plain(cuda, kind):
    from grab_tpu_torch.ops import alpharun as ar

    range_sets = [((48, 57),), ((0, 0), (48, 57)), ((0x80, 0xBF), (0xF0, 0xFF)),
                  tuple((16 * i + 1, 16 * i + 6) for i in range(8)), ((0, 255),)]
    plans = [("coarse", u) for u in (1, 2, 4, 8)] + [("fine", u) for u in (1, 2, 4)]
    for i, ranges in enumerate(range_sets):
        w = torch.from_numpy(_run_words(kind, ranges, i)).to(cuda)
        for mode, units in plans:
            before = ar.alpharun_flags.launches
            got = ar.alpharun_flags(w, ranges, mode, units)
            assert ar.alpharun_flags.launches == before + 1
            bm = ar.alpharun_bitmap_torch(w, ranges, mode, units)
            want = cw.packed_block_flags(bm) + (bm,)
            torch.cuda.synchronize()
            for g, x in zip(got, want):
                assert g.dtype == x.dtype and torch.equal(g, x), (ranges, mode, units)
        assert int(got[0].item()) > 0


ALPHA_PLANS = [("coarse", u) for u in (1, 2, 4, 8)] + [("fine", u) for u in (1, 2, 4)]


def _ranges_of_count(n: int):
    """n disjoint ranges; an even count holds byte 0 (the pad rows are
    members), counts over 4 hold bytes >= 0x80."""
    out = [(30 * i + 20, 30 * i + 24 + i) for i in range(n)]
    if n % 2 == 0:
        out[0] = (0, 0)
    return tuple(out)


def _odd_groups(w: np.ndarray, groups: int) -> np.ndarray:
    """The first 32 * groups rows of a word buffer and 8 zero pad rows:
    a group count that no block of group_count.cuh's 8 warp groups divides."""
    return np.concatenate([w[: 32 * groups], np.zeros((PAD_ROWS, LANES), "<i4")])


def _assert_word_kernel(got, bm):
    want = cw.packed_block_flags(bm) + (bm,)
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and torch.equal(g, x)


@pytest.mark.gpu
@pytest.mark.parametrize("n_ranges", range(1, 9))
def test_alpharun_kernel_every_range_count(cuda, n_ranges):
    """Every range count the kernel is compiled for, every mode and
    unit, on planted runs across row, group and buffer-end boundaries,
    at 16 groups and at 13 (a block of 8 groups left part-empty)."""
    from grab_tpu_torch.ops import alpharun as ar

    ranges = _ranges_of_count(n_ranges)
    for kind in ("text", "binary", "zeros"):
        full = _run_words(kind, ranges, n_ranges)
        for w_np in (full, _odd_groups(full, 13)):
            w = torch.from_numpy(w_np).to(cuda)
            for mode, units in ALPHA_PLANS:
                got = ar.alpharun_flags(w, ranges, mode, units)
                _assert_word_kernel(got, ar.alpharun_bitmap_torch(w, ranges, mode, units))
                if kind != "zeros" or n_ranges % 2 == 0:
                    assert int(got[0].item()) > 0, (kind, mode, units)


@pytest.mark.gpu
@pytest.mark.parametrize("n_seqs", [1, 8, 32])
def test_classseq_kernel_every_span(cuda, n_seqs):
    """1, 8 and 32 sequences (the three descriptor sizes), spans 1-8, the
    needles at row, group, lane-127 and buffer-end places, at 16 groups
    and at 13."""
    from grab_tpu_torch.ops import classseq as cs

    rng = np.random.default_rng(40 + n_seqs)

    def cls():
        lo = int(rng.integers(32, 250))
        m = sum(1 << b for b in range(lo, min(256, lo + 1 + int(rng.integers(0, 9)))))
        return m | (HIGH if rng.random() < 0.2 else 0) | (DIGIT if rng.random() < 0.3 else 0)

    for span in range(1, 9):
        seqs = [tuple(cls() for _ in range(span))]
        seqs += [tuple(cls() for _ in range(1 + (span + i) % 8)) for i in range(n_seqs - 1)]
        seqs = cs.compile_sequences(seqs)
        needles = [bytes(int(rng.integers(lo, hi + 1)) for lo, hi in
                         (c[int(rng.integers(0, len(c)))] for c in seq)) for seq in seqs]
        for kind in ("text", "binary", "zeros"):
            full = _words(kind, needles, span)
            for w_np in (full, _odd_groups(full, 13)):
                w = torch.from_numpy(w_np).to(cuda)
                got = cs.classseq_flags(w, seqs)
                _assert_word_kernel(got, cs.classseq_bitmap_torch(w, seqs))
                assert int(got[0].item()) > 0, (span, kind)


@pytest.mark.gpu
def test_word_counts_on_two_streams(cuda):
    """B3, B4 and B5 count `total` through a scratch per (device,
    stream): launches interleaved on two streams of one card, each on
    buffers of its own, give every launch its own total, and leave both
    scratches at zero."""
    from grab_tpu_torch.ops import alpharun as ar
    from grab_tpu_torch.ops import classseq as cs
    from grab_tpu_torch.ops import xorfilter as xf
    from grab_tpu_torch.ops.corewords import count_scratch

    seqs = cs.compile_sequences([(DIGIT,) * 5])
    ranges = ((48, 57),)
    lits = _long_literals(100, 8)
    xor = xf.XorWordTests(lits)
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    bufs = []
    for i in range(6):
        w = _run_words("text", ranges, 50 + i)
        flat = w[: N // BLOCK].reshape(-1).view(np.uint8)
        for j, lit in enumerate(lits[: 10 + 5 * i]):  # literals in ever more groups
            pos = 6151 * j + 8
            flat[pos : pos + len(lit)] = np.frombuffer(lit, np.uint8)
        w[: 32 * i] = 0  # a different count per buffer
        bufs.append(torch.from_numpy(w).to(cuda))
    torch.cuda.synchronize()
    got = []
    for rep in range(20):
        for i, w in enumerate(bufs):
            with torch.cuda.stream(streams[i % 2]):
                got.append(ar.alpharun_flags(w, ranges, "coarse", 1)[0])
                got.append(cs.classseq_flags(w, seqs)[0])
                got.append(xf.xor_word_flags(w, xor)[0])
    torch.cuda.synchronize()
    want = []
    for w in bufs:
        want.append(int(cw.packed_block_flags(ar.alpharun_bitmap_torch(w, ranges, "coarse", 1))[0]))
        want.append(int(cw.packed_block_flags(cs.classseq_bitmap_torch(w, seqs))[0]))
        want.append(int(cw.packed_block_flags(
            xf.xor_bitmap_torch(w, xor.tables(), xor.consts()))[0]))
    assert len(set(want)) > 2
    assert [int(t.item()) for t in got] == want * 20
    for st in streams:
        with torch.cuda.stream(st):
            assert count_scratch(cuda).tolist() == [0, 0]


def _long_literals(k: int, seed: int):
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(33, 127, size=int(rng.integers(7, 12)), dtype=np.uint8))
            for _ in range(k)]


def _grown(w: np.ndarray, rows: int) -> np.ndarray:
    """A word buffer of ``rows`` rows (+ 8 zero pad rows) repeated out of
    ``w``'s, its last 64 bytes ``w``'s last 64 (a hit in the last word)."""
    body = np.resize(w[:-PAD_ROWS], (rows, LANES))
    body[-1, -16:] = w[-PAD_ROWS - 1, -16:]
    return np.concatenate([body, np.zeros((PAD_ROWS, LANES), "<i4")])


# 5, 40, 100 literals: 32 bank copies; 1000: one copy; 10,000: global memory
XOR_FORMS = {5: (32, 1), 40: (32, 3), 100: (32, 1), 1000: (1, 3), 10000: (0, 2)}


@pytest.mark.gpu
@pytest.mark.parametrize("k", [5, 40, 100, 1000, 10000])
def test_xor_kernel_matches_plain(cuda, k):
    """Every form the launch takes (bank copies, remainder arity), at 16
    groups, at 2045 (no multiple of a block's 8 groups) and at 40 MiB."""
    from grab_tpu_torch.ops import xorfilter as xf

    lits = _long_literals(k, k)
    tests = xf.XorWordTests(lits)
    for kind in ("text", "binary", "zeros"):
        small = _words(kind, lits, k)
        for w_np in (small, _grown(small, 2045 * 32), _grown(small, (40 << 20) // BLOCK)):
            w = torch.from_numpy(w_np).to(cuda)
            before = xf.xor_word_flags.launches
            got = xf.xor_word_flags(w, tests)
            assert xf.xor_word_flags.launches == before + 1
            assert xf.xor_word_flags.form == XOR_FORMS[k]
            _assert_word_kernel(got, xf.xor_bitmap_torch(w, tests.tables(), tests.consts()))
            assert int(got[0].item()) > 0
    nul = torch.zeros((64 + PAD_ROWS, LANES), dtype=torch.int32, device=cuda)
    assert int(xf.xor_word_flags(nul, tests)[0].item()) == 0  # NUL words are no members


def _any_shape_tests(xf, lits):
    """The filter of ``lits`` rebuilt as groups of arities 2, 4, 1, 3: a
    shape the kernel does not unroll (the construction's split fallback
    can make one)."""
    tests = xf.XorWordTests(lits)
    keys = sorted({w for lit in lits for _j, w in xf._phase_words(lit)})
    tests.groups = []
    for lo, hi, arity in ((0, 100, 2), (100, 484, 4), (484, 500, 1), (500, len(keys), 3)):
        tests._build_group(keys[lo:hi], arity)
    return tests


@pytest.mark.gpu
@pytest.mark.parametrize("copies", [32, 16, 1, 0])
def test_xor_kernel_every_form(cuda, monkeypatch, copies):
    """Each bank-copy form, forced, with every remainder arity (5, 25, 40,
    80 literals: 1, 2, 3, 4) and with a shape of any arities (the
    per-group dispatch), at 16 groups and at 13."""
    from grab_tpu_torch.ops import xorfilter as xf

    monkeypatch.setattr(xf, "bank_copies", lambda n_groups, n_rows: copies)
    cases = [(k, xf.XorWordTests(_long_literals(k, 60 + k))) for k in (5, 25, 40, 80)]
    cases.append((200, _any_shape_tests(xf, _long_literals(200, 9))))
    for k, tests in cases:
        rem = xf.remainder_arity(tests.consts())
        assert rem == {5: 1, 25: 2, 40: 3, 80: 4, 200: 0}[k]
        for kind in ("text", "binary"):
            full = _words(kind, tests.literals, k)
            for w_np in (full, _odd_groups(full, 13)):
                w = torch.from_numpy(w_np).to(cuda)
                got = xf.xor_word_flags(w, tests)
                assert xf.xor_word_flags.form == (copies, rem)
                _assert_word_kernel(got, xf.xor_bitmap_torch(w, tests.tables(), tests.consts()))
                assert int(got[0].item()) > 0, (k, kind)


def _fused_ensembles():
    from grab_tpu_torch.ops.classseq import compile_sequences

    rng = np.random.default_rng(6)
    shorts = [bytes(rng.integers(97, 123, size=int(rng.integers(3, 7)), dtype=np.uint8))
              for _ in range(60)]
    one = compile_sequences([(DIGIT, DIGIT, DIGIT, HIGH)])
    three = compile_sequences([(DIGIT,) * 5, (HIGH, DIGIT, HIGH), (DIGIT,) * 8])
    return [
        (_long_literals(100, 1), one),  # the 100-literal batch: filter + 1 sequence
        (shorts + _long_literals(40, 2), three),  # 4 buckets + filter + sequences
        ([b"linus", b"lmnus"], three),  # one bucket + sequences
        (_long_literals(3, 3) + shorts[:30], None),  # buckets only, W=2 masked
        ([b"needle%02dXY" % i for i in range(4)] + _long_literals(8, 4), None),  # filter only
        (shorts * 20, None),  # 75 buckets: the program exceeds 48 KiB of shared memory
        (shorts * 64, None),  # 240 buckets: the program is read from global memory
    ]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["text", "binary", "zeros"])
def test_fused_kernel_matches_plain(cuda, kind):
    from grab_tpu_torch.ops import fused as fu

    for i, (lits, seqs) in enumerate(_fused_ensembles()):
        sc = fu.FusedEnsembleScanner(lits, seqs)
        plants = lits[:6] + [b"123\x80", b"12345", b"\x85" + b"7\x81"]
        w = torch.from_numpy(_words(kind, plants, i)).to(cuda)
        before = fu.fused_word_flags.launches
        got = fu.fused_word_flags(w, sc)
        assert fu.fused_word_flags.launches == before + 1
        bm = fu.fused_bitmap_torch(w, sc)
        want = cw.packed_block_flags(bm) + (bm,)
        torch.cuda.synchronize()
        for g, x in zip(got, want):
            assert g.dtype == x.dtype and torch.equal(g, x), (i, sc.cw_shapes)
        assert int(got[0].item()) > 0


@pytest.mark.gpu
def test_fused_kernel_batch4_matches_plain(cuda):
    """The ensemble DeviceScanner builds for the 100-literal + 10-regex
    batch: two 16-literal buckets, one of 2, 5 banks, 3 sequences."""
    from grab_tpu_torch.ops import fused as fu
    from grab_tpu_torch.regex.compiler import compile_multi
    from grab_tpu_torch.scan_pipeline import DeviceScanner

    # tests/test_mixed_batch.py build()'s patterns, without its JAX imports
    rng = np.random.default_rng(12)
    pats = [bytes(rng.integers(97, 123, size=int(rng.integers(7, 12)), dtype=np.uint8))
            for _ in range(100)]
    pats += [rb"foo[a-z]{2,6}bar", rb"[0-9]{3}-[0-9]{4}", rb"qu+x", rb"colou?r",
             rb"abc(def|ghi)jkl", rb"w[xyz]{3}w", rb"nee+dle", rb"[A-Z]{5}99",
             rb"zz(?:a|b|c)zz", rb"end\.x"]
    sc = DeviceScanner(compile_multi(pats), buf_size=1 << 20, devices=["cpu"]).members[0]
    assert type(sc) is fu.FusedEnsembleScanner and len(sc.seqs) == 3
    plants = [b"555-1234", b"QWERT99", b"quuux"] + pats[:5]
    for i, kind in enumerate(("text", "binary", "zeros")):
        w = torch.from_numpy(_words(kind, plants, 20 + i)).to(cuda)
        got = fu.fused_word_flags(w, sc)
        bm = fu.fused_bitmap_torch(w, sc)
        want = cw.packed_block_flags(bm) + (bm,)
        torch.cuda.synchronize()
        for g, x in zip(got, want):
            assert g.dtype == x.dtype and torch.equal(g, x), kind
        assert int(got[0].item()) > 0


ENSEMBLE_PLANS = {
    "fused + stride member": [b"[0-9]{3}[a-z]{2}", b"[0-9]{4}[a-z]", b"qZxW", b"kV9#p"]
    + [b"needle_%d" % i for i in range(5)],
    "fused, one sequence": [b"needle", b"linus", rb"[0-9]{3}[a-z]{2}"]
    + [b"longliteral%02d" % i for i in range(6)],
    "alpha": [rb".{0,2}[0-9]{11}"],
    "last-resort walk": [rb".{0,2}(?:[a-f][0-9][g-m][A-F][N-Z]){3}"],
}


@pytest.mark.gpu
@pytest.mark.parametrize("no_fused", [False, True])
@pytest.mark.parametrize("plan", list(ENSEMBLE_PLANS))
def test_device_scanner_ensembles_match_cpu(cuda, monkeypatch, plan, no_fused):
    """Multi-member scanners (two uploads beside a stride member), alpha
    and the walk, two batches in flight: flags equal the CPU scanner's."""
    from grab_tpu_torch.regex.compiler import compile_multi
    from grab_tpu_torch.scan_pipeline import DeviceScanner, release_lanes, take_lanes

    monkeypatch.delenv("GRAB_TPU_SEQDFA", raising=False)
    if no_fused:
        monkeypatch.setenv("GRAB_TPU_NO_FUSED", "1")
    else:
        monkeypatch.delenv("GRAB_TPU_NO_FUSED", raising=False)
    buf_size = (64 << 10) if plan == "last-resort walk" else (1 << 20)
    cp = compile_multi(ENSEMBLE_PLANS[plan])
    dev = DeviceScanner(cp, buf_size=buf_size, devices=["cuda"])
    cpu = DeviceScanner(cp, buf_size=buf_size, devices=["cpu"])
    assert dev.mode == cpu.mode
    assert [type(m) for m in dev.members] == [type(m) for m in cpu.members]
    rng = np.random.default_rng(11)
    bufs = []
    for i in range(3):
        b = rng.choice(np.frombuffer(b" -_=+()\nghijkm", np.uint8), size=buf_size + 4096)
        b[buf_size:] = 0
        for pos in (100 + i, 4093, buf_size // 3, buf_size - 60):
            for k, s in enumerate((b"123ab", b"4567q", b"qZxW", b"needle_3", b"linus",
                                   b"longliteral04", b"x91827364550x", b"a1gANb2hBOc3hDP")):
                at = min(pos + 17 * k, buf_size - len(s))
                b[at : at + len(s)] = np.frombuffer(s, np.uint8)
        bufs.append(b)
    bufs[1][:] = ord("-")
    lanes = take_lanes(dev.lanes)
    pending = dev.submit(lanes, bufs[:1])
    got = []
    for b in bufs[1:]:
        pending += dev.submit(lanes, [b])
        got.append(dev.resolve(pending.pop(0)))
    got.append(dev.resolve(pending.pop(0)))
    release_lanes(lanes)
    for g, b in zip(got, bufs):
        want = cpu.scan(b)
        assert g.dtype == want.dtype and (g == want).all()
    assert got[0].any() and not got[1].any()


# -- stride transpose (B7), bloom (B8), the group submit and the server ------


@pytest.mark.gpu
@pytest.mark.parametrize("s_w", [32, 128, 512, 640])
def test_stride_transpose_kernel_matches_plain(cuda, s_w):
    from grab_tpu_torch.ops import stridedfa as sd

    rng = np.random.default_rng(s_w)
    a = torch.from_numpy(
        rng.integers(-(1 << 31), 1 << 31, size=(sd.N_STREAMS, s_w), dtype=np.int64)
        .astype(np.int32)).to(cuda)
    before = sd.stride_transpose.launches
    got = sd.stride_transpose(a, s_w)
    assert sd.stride_transpose.launches == before + 1
    want = sd.stride_transpose_torch(a, s_w)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)
    with pytest.raises(ValueError):  # not contiguous
        sd.stride_transpose(a.t().contiguous().t(), s_w)
    with pytest.raises(ValueError):  # s_w not a multiple of 32
        sd.stride_transpose(a[:, :31].contiguous(), 31)


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", [rb".{0,2}[a-z ]{11}", rb".{0,2}(?:[0-9a-zA-Z]{4})+"])
def test_stride_scanner_linear_entries_match_transposed(cuda, pattern):
    """run(words) on the linear upload == run_t(prep_t(buf)), window
    mode and threading, with hits across stream boundaries."""
    from grab_tpu_torch.ops import stridedfa as sd
    from grab_tpu_torch.regex.compiler import compile_multi

    cp = compile_multi([pattern])
    sc = sd.StrideDfaScanner(cp.dfa, cp.max_len, 2 << 20)
    rng = np.random.default_rng(4)
    buf = rng.choice(np.frombuffer(b" -_=+()\n", np.uint8), size=(2 << 20) - 100)
    for s in range(3, 16000, 211):
        at = s * sc.stride - 5
        buf[at : at + 20] = np.frombuffer(b"hello world a1B2c3D4", np.uint8)
    before = sd.stride_transpose.launches
    bm, n, conv = sc.run(torch.from_numpy(sc.prep(buf).copy()).to(cuda))
    assert sd.stride_transpose.launches == before + 1
    bm_t, n_t, conv_t = sc.run_t(torch.from_numpy(sc.prep_t(buf)).to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(bm, bm_t) and (int(n), bool(conv)) == (int(n_t), bool(conv_t))
    assert int(torch.count_nonzero(bm)) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 5, 100, 1000])
def test_bloom_kernel_matches_plain(cuda, k):
    from grab_tpu_torch.ops import bloom as bl

    lits = _long_literals(k, 50 + k)
    tests = bl.BloomWordTests(lits)
    for kind in ("text", "binary", "zeros"):
        w = torch.from_numpy(_words(kind, lits, k)).to(cuda)
        before = bl.bloom_word_flags.launches
        got = bl.bloom_word_flags(w, tests)
        assert bl.bloom_word_flags.launches == before + 1
        bm = bl.bloom_bitmap_torch(w, tests.tbl, tests.levels)
        want = cw.packed_block_flags(bm) + (bm,)
        torch.cuda.synchronize()
        for g, x in zip(got, want):
            assert g.dtype == x.dtype and torch.equal(g, x), (k, kind)
        assert int(got[0].item()) > 0
    sc = bl.BloomWordScanner(lits)
    total, packed = sc.packed(w)
    flags = sc.flags_np(packed.cpu().numpy(), N // BLOCK)
    assert flags[0] == 1  # _words plants the first literal at offset 0


GROUP_PLANS = {
    "literal": [b"l[imn]nus"],
    "class_seq, stride member": [rb"[A-Z]{6}[0-9]{6}"],
    "gdfa, threading": [rb".{0,2}(?:[0-9a-zA-Z]{4})+"],
    "alpha": [rb".{0,2}[0-9]{11}"],
    "fused + stride member": ENSEMBLE_PLANS["fused + stride member"],
}


def _group_devices():
    """Every visible card as one lane each, or two lanes on the one."""
    n = torch.cuda.device_count()
    return "cuda" if n > 1 else "cuda:0,cuda:0", max(n, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("plan", list(GROUP_PLANS))
def test_sharded_scanner_matches_cpu(cuda, monkeypatch, plan):
    """Groups over the shard devices (two lanes on one card where there
    is only one), two groups in flight as CorpusPipeline keeps them, a
    short last group and a clean one: flags equal the CPU scanner's in
    submit order, and a clean group pulls no payload."""
    from grab_tpu_torch.parallel.scan_step import shard_devices
    from grab_tpu_torch.regex.compiler import compile_multi
    from grab_tpu_torch.scan_pipeline import DeviceScanner, release_lanes, take_lanes

    for var in ("GRAB_TPU_NO_FUSED", "GRAB_TPU_SEQDFA"):
        monkeypatch.delenv(var, raising=False)
    devices, n = _group_devices()
    buf_size = 1 << 20
    cp = compile_multi(GROUP_PLANS[plan])
    sh = DeviceScanner(cp, buf_size=buf_size, devices=shard_devices(n, devices))
    cpu = DeviceScanner(cp, buf_size=buf_size, devices=["cpu"])
    assert len(sh.lanes) == n and sh.mode == cpu.mode
    lanes = take_lanes(sh.lanes)
    # lane 0 on the caller's stream, every other lane on a stream of its own
    assert lanes[0].stream is None and len({id(l.stream) for l in lanes[1:]}) == n - 1
    rng = np.random.default_rng(13)
    bufs = []
    for i in range(2 * n + 1):
        b = rng.choice(np.frombuffer(b" -_=+()\nghijkm", np.uint8), size=buf_size + 4096)
        b[buf_size:] = 0
        for pos in (100 + i, 4093, buf_size // 3, buf_size - 60):
            for k, s in enumerate((b"linus", b"QWERTY123456", b"a1B2c3D4", b"x91827364550x",
                                   b"123ab", b"needle_3")):
                at = min(pos + 17 * k, buf_size - len(s))
                b[at : at + len(s)] = np.frombuffer(s, np.uint8)
        bufs.append(b)
    for b in bufs[n : 2 * n]:
        b[:buf_size] = ord("-")  # the second group is clean
    groups = [bufs[:n], bufs[n : 2 * n], bufs[2 * n :]]
    pending = [sh.submit(lanes, groups[0])]
    got, pulls = [], []
    for g in groups[1:]:
        pending.append(sh.submit(lanes, g))
        got += [sh.resolve(h) for h in pending.pop(0)]
        pulls.append(sh.payload_pulls)
    got += [sh.resolve(h) for h in pending.pop(0)]
    pulls.append(sh.payload_pulls)
    release_lanes(lanes)
    assert pulls == [n, n, n + 1]  # the clean group pulled nothing
    assert len(got) == len(bufs)
    for i, (g, b) in enumerate(zip(got, bufs)):
        want = cpu.scan(b)
        assert g.dtype == want.dtype and (g == want).all(), i
        assert bool(g.any()) == (not n <= i < 2 * n)


@pytest.mark.gpu
def test_cli_group_stdout_matches_single(cuda, monkeypatch, tmp_path):
    """-n N through the CLI on the card(s) prints what -n 1 prints."""
    import io

    from grab_tpu_torch import cli

    rng = np.random.default_rng(17)
    (tmp_path / "sub").mkdir()
    for i in range(5):
        n = (3 << 20) + 70_001 * i
        data = rng.integers(97, 123, size=n, dtype=np.uint8)
        data[::97] = 0x0A
        for p in range(500, n - 40, 300_007):
            data[p : p + 8] = np.frombuffer(b"needle%02d" % i, np.uint8)
        (tmp_path / ("sub" if i % 2 else ".") / f"f{i}.txt").write_bytes(data.tobytes())
    devices, n = _group_devices()

    def run(argv, dev):
        monkeypatch.setenv("GRAB_TPU_TORCH_DEVICE", dev)
        out, err = io.BytesIO(), io.StringIO()
        assert cli.main(argv, out=out, err=err) == 0, err.getvalue()
        return out.getvalue()

    # -n N quarters the chunk as -L -L does: the same flush boundaries
    for pat in ("needle0[0-9]", "[a-z]eedle[0-9]{2}"):
        one = run(["-L", "-L", "-r", "-O", pat, str(tmp_path)], "cuda:0")
        many = run(["-n", str(n), "-r", "-O", pat, str(tmp_path)], devices)
        capped = run(["-n", "64", "-r", "-O", pat, str(tmp_path)], "cuda:0")
        assert one and many == one and capped == one


@pytest.mark.gpu
def test_server_warm_start_and_round_trip(cuda, tmp_path):
    """The server as a subprocess on the card: the warm-up builds and
    launches the kernels before the socket appears; a request's stdout
    equals the direct CLI's."""
    import os
    import subprocess
    import sys
    import time

    (tmp_path / "f.txt").write_bytes(b"abc needleXY def\n" * 4000)
    sock = str(tmp_path / "s.sock")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    env.pop("GRAB_TPU_TORCH_DEVICE", None)
    srv = subprocess.Popen([sys.executable, "-m", "grab_tpu_torch.server", sock], env=env,
                           cwd=repo, stderr=subprocess.PIPE)
    try:
        for _ in range(1200):
            if os.path.exists(sock) or srv.poll() is not None:
                break
            time.sleep(0.25)
        assert srv.poll() is None and os.path.exists(sock), srv.stderr.read().decode()[-2000:]
        argv = ["-r", "-O", "needleXY", str(tmp_path)]
        via = subprocess.run([sys.executable, "-m", "grab_tpu_torch.cli", "--via", sock] + argv,
                             env=env, cwd=repo, capture_output=True, timeout=300)
        direct = subprocess.run([sys.executable, "-m", "grab_tpu_torch.cli"] + argv,
                                env=env, cwd=repo, capture_output=True, timeout=300)
        assert via.returncode == direct.returncode == 0
        assert via.stdout == direct.stdout and via.stdout.count(b"\n") == 8000
    finally:
        srv.terminate()
        srv.wait(timeout=30)


@pytest.mark.gpu
def test_cached_plans_keep_card_memory_flat(cuda, tmp_path, monkeypatch):
    """20 requests with distinct literals through the server's cache:
    each builds and keeps a plan of its own, and all of them fill and
    upload through the card's one lane, so after the first request
    neither the pinned slots nor the card's allocated memory grow (but
    for each plan's own tables: kilobytes)."""
    import io

    from grab_tpu_torch import scan_pipeline
    from grab_tpu_torch.server import _EngineCache, _run_with_cache

    monkeypatch.setattr(scan_pipeline, "_LANES", {})
    monkeypatch.setenv("GRAB_TPU_TORCH_DEVICE", "cuda:0")
    rng = np.random.default_rng(20)
    data = rng.integers(97, 123, size=(40 << 20) + 999, dtype=np.uint8)  # two 32 MiB batches
    data[::97] = 10
    (tmp_path / "a.log").write_bytes(data.tobytes())
    cache = _EngineCache()

    def pinned_slots():
        return sum(len(slot) for pool in scan_pipeline._LANES.values() for lane in pool
                   for slot in lane._pinned)

    seen = []
    for i in range(20):
        out, err = io.BytesIO(), io.StringIO()
        argv = ["-r", "-S", "zq%02dxkv" % i, str(tmp_path)]
        assert _run_with_cache(argv, cache, out, err, i + 1) == 0, err.getvalue()
        assert out.getvalue() == b""
        torch.cuda.synchronize()
        seen.append((pinned_slots(), torch.cuda.memory_allocated()))
    assert (cache.hits, cache.misses) == (0, 20) and len(cache._scanners) == 20
    assert seen[0][0] == 2 and all(n == seen[0][0] for n, _ in seen), seen
    assert max(m for _, m in seen) - seen[0][1] < (1 << 20), seen


# -- the last-resort DFA walk (csrc/dfa_walk.cu) --------------------------------

WALK_NO_PLAN = rb".{0,2}(?:[a-f][0-9][g-m][A-F][N-Z]){200}"  # 1001 states, 7 classes
WALK_HIT = b"a1gAN" + b"b2hBO" * 199
WIDE_BODY = bytes(b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"[(i * 7) % 62]
                  for i in range(1900))
# 1901 states x 64 classes: a class table of 243,328 bytes, over the
# kernel's 200 KiB of shared memory (its global-memory form)
WALK_WIDE = b".{0,2}" + WIDE_BODY
WALK_CASES = {  # name: (pattern, its planted match, buffer bytes, stream_seg)
    "no-plan-1x16K": (WALK_NO_PLAN, WALK_HIT, 16 << 10, 32768),
    # one stream of 256 segments: walked in two tiles of 128, one after
    # the other
    "no-plan-1x128K": (WALK_NO_PLAN, WALK_HIT, 128 << 10, 128 << 10),
    "no-plan-16x32K": (WALK_NO_PLAN, WALK_HIT, 512 << 10, 32768),
    "no-plan-64x33024": (WALK_NO_PLAN, WALK_HIT, 2064 << 10, 32768),
    "no-plan-64x768": (WALK_NO_PLAN, WALK_HIT, 48 << 10, 768),
    "a-z11-16x32K": (rb".{0,2}[a-z ]{11}", b"hello world", 512 << 10, 32768),
    "wide-64x32K": (WALK_WIDE, WIDE_BODY, 2 << 20, 32768),
    # the parity of the letters since a Q never synchronises: over
    # lowercase text with one Q near each stream's start, every guess
    # after it is wrong and the fix-up re-walks the stream
    "non-sync-64x32K": (rb"Q(?:[a-z]{2})*Q", b"QxyQ", 2 << 20, 32768),
}


def _walk_case(case):
    """(member, buffer, planted spots) of one WALK_CASES case."""
    from grab_tpu_torch.ops import dfa_scan as ds
    from grab_tpu_torch.regex.compiler import compile_multi

    pattern, hit, n, stream_seg = WALK_CASES[case]
    member = ds.DfaWalkMember(compile_multi([pattern]).dfa, n, BLOCK, stream_seg, 0x1000)
    seg = n // member.n_streams
    rng = np.random.default_rng(len(case))
    if case.startswith("non-sync"):
        buf = rng.integers(ord("a"), ord("z") + 1, size=n, dtype=np.uint8)
        buf[7::seg] = ord("Q")
    else:
        buf = rng.integers(32, 127, size=n, dtype=np.uint8)
    spots = [100, n - len(hit)]
    spots += [s * seg - len(hit) // 2 for s in range(1, member.n_streams, 3)
              if len(hit) // 2 < min(seg, 0x1000)]  # across a boundary, ends in the halo
    for pos in spots:
        buf[pos : pos + len(hit)] = np.frombuffer(hit, np.uint8)
    return member, buf, spots


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(WALK_CASES))
def test_dfa_walk_kernel_matches_plain(cuda, case):
    """One launch of csrc/dfa_walk.cu per buffer == the plain walk on the
    card (total and packed flags), at one stream (and one walked in two
    tiles), 16 streams of 32 KiB, segments of 33,024 and 768 bytes
    (blocks across streams), a class table in global memory and an
    automaton that never synchronises, twice in a row (the launch leaves
    its scratch zero); every planted match's end is flagged."""
    from grab_tpu_torch.ops import dfa_scan as ds

    member, buf, spots = _walk_case(case)
    n = len(buf)
    hit = WALK_CASES[case][1]
    if case.startswith("wide"):
        assert member.tables.class_table.nbytes > 200 << 10
    data = torch.from_numpy(buf).to(cuda)
    ds.fixup_bytes(data.device, reset=True)
    before = ds.dfa_walk_flags.launches
    total, packed = member.packed(data)
    assert ds.dfa_walk_flags.launches == before + 1
    assert ds.dfa_walk_flags.shared_table == (not case.startswith("wide"))
    rewalked = ds.fixup_bytes(data.device, reset=True)
    want = ds.dfa_walk_flags_torch(data, member.tables, member.n_streams, 0x1000, BLOCK)
    torch.cuda.synchronize()
    assert torch.equal(total, want[0]) and torch.equal(packed, want[1])
    again = member.packed(data)
    assert torch.equal(again[0], want[0]) and torch.equal(again[1], want[1])
    flags = member.flags_np(packed.cpu().numpy(), n // BLOCK)
    for pos in spots:
        if buf[pos : pos + len(hit)].tobytes() == hit:
            assert flags[(pos + len(hit) - 1) // BLOCK] == 1, (case, pos)
    assert int(total.item()) == int(flags.sum()) > 0
    if case.startswith("non-sync"):
        assert rewalked > n // 2


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["no-plan-1x128K", "no-plan-16x32K", "no-plan-64x33024",
                                  "no-plan-64x768", "non-sync-64x32K"])
def test_dfa_walk_counts_kernel_matches_plain(cuda, case):
    """The counts walk (csrc/dfa_walk.cu: the walk into records sized by
    walk_geometry, which the kernel checks against its own geometry, then
    the count kernel; two launches) == the plain walk's block counts on
    the card, with halo bits ORed per position."""
    from grab_tpu_torch.ops import dfa_scan as ds

    member, buf, _ = _walk_case(case)
    data = torch.from_numpy(buf).to(cuda)
    before = ds.dfa_walk_counts.launches
    got = ds.dfa_walk_counts(data, member.tables, member.n_streams, 0x1000, BLOCK)
    assert ds.dfa_walk_counts.launches == before + 2
    want = ds.dfa_walk_counts_torch(data, member.tables, member.n_streams, 0x1000, BLOCK)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want) and int(want.sum()) > 0


@pytest.mark.gpu
def test_dfa_walk_wrapper_refuses_bad_input_on_card(cuda):
    from grab_tpu_torch.ops import dfa_scan as ds
    from grab_tpu_torch.regex.compiler import compile_multi

    member = ds.DfaWalkMember(compile_multi([WALK_NO_PLAN]).dfa, 48 << 10, BLOCK, 768, 0x1000)
    buf = torch.zeros((48 << 10) + 16, dtype=torch.uint8, device=cuda)
    before = ds.dfa_walk_flags.launches
    with pytest.raises(ValueError):  # not 16-byte aligned
        member.packed(buf[1 : 1 + (48 << 10)])
    with pytest.raises(ValueError):  # 7 streams do not divide the buffer
        ds.dfa_walk_flags(buf[: 48 << 10], member.tables, 7)
    assert ds.dfa_walk_flags.launches == before


@pytest.mark.gpu
def test_request_spans_on_card(cuda, tmp_path, monkeypatch):
    """--stats --trace of a recursive scan on the card: stage, launch and
    wait are nonzero, the pipeline's spans partition scan= (5% or 5 ms),
    and the spans are host ranges of the CUDA trace, inside the
    profiler's window beside the device's operations; kineto's
    gpu_user_annotation copies of them add no device time."""
    import io
    import json

    from grab_tpu_torch import cli
    from grab_tpu_torch.engine import PIPELINE_SPANS, Engine
    from scanbench import tracefile

    monkeypatch.setenv("GRAB_TPU_TORCH_DEVICE", "cuda")
    root = tmp_path / "d"
    root.mkdir()
    rng = np.random.default_rng(7)
    for i, n in enumerate((30 << 20, 40 << 20, 3 << 20)):
        data = rng.integers(97, 123, size=n, dtype=np.uint8)
        data[::97] = 10
        data[n // 2 : n // 2 + 8] = np.frombuffer(b"needleXY", dtype=np.uint8)
        (root / f"f{i}.txt").write_bytes(data.tobytes())
    engines = []

    def keep(pats, cfg):
        engines.append(Engine(pats, cfg))
        return engines[-1]

    # a first scan builds and loads what the process needs, as a server's warm-up does
    assert cli.main(["-r", "needleXY", str(root)], out=io.BytesIO(), err=io.StringIO()) == 0
    out, err = io.BytesIO(), io.StringIO()
    d = tmp_path / "t"
    rc = cli.main(["--stats", "--trace", str(d), "-r", "needleXY", str(root)], out=out, err=err,
                  engine_factory=keep, request=4)
    assert rc == 0 and out.getvalue().count(b"needleXY") == 3, err.getvalue()
    st = engines[0].stats
    assert all(st.spans.get(k, 0.0) > 0 for k in ("walk", "fill", "stage", "launch", "wait", "pull"))
    parts = st.spans["walk"] + sum(st.spans.get(k, 0.0) for k in PIPELINE_SPANS)
    assert abs(parts - st.wall_scan) <= max(0.05 * st.wall_scan, 0.005), (parts, st.wall_scan, st.spans)
    assert st.device_batches >= 3 and st.pulls >= 1 and " | req=4 " in err.getvalue()
    events = json.loads((d / "trace.json").read_text())["traceEvents"]
    prof = [e for e in events if str(e.get("name", "")).startswith("PyTorch Profiler")][0]
    lo, hi = prof["ts"], prof["ts"] + prof["dur"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    assert {"walk", "pack", "fill", "stage", "launch", "wait", "pull"} <= {e["name"] for e in ranges}
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in ranges)
    device = [e for e in events if e.get("cat") in tracefile.DEVICE_CATS]
    assert device and all(lo <= e["ts"] <= hi for e in device)
    t = tracefile.summarize(events)
    bare = tracefile.summarize([e for e in events if e.get("cat") != "gpu_user_annotation"])
    assert t.busy_us == bare.busy_us > 0 and not any(k in t.ops_us for k in PIPELINE_SPANS)


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 2], ids=["one lane", "-n 2"])
@pytest.mark.parametrize("pattern", ["linear", "stride-only"])
@pytest.mark.parametrize("case", ["stale_tail", "padding", "shrunk"])
def test_pinned_slot_fill_matches_cpu(cuda, tmp_path, monkeypatch, case, pattern, shards):
    """tests/test_torch_fill.py's stale-slot sequences through the
    pinned upload ring (1 MiB buffers; two lanes on one card for -n 2):
    every buffer as submitted, its flags, stdout and cand_blocks equal
    the CPU path's reused ring; a literal's batches are all filled in
    place, a stride member's alone none."""
    # by the file's directory, which pytest puts on sys.path for this
    # package-less folder: a site-wide ``tests`` package may shadow ours
    from _fill_cases import scan_tree, stats_field

    from grab_tpu_torch import scan_pipeline

    # lanes of the test's own, as a new process has: what earlier tests
    # left in the process's slots must not decide which claims are stale
    monkeypatch.setattr(scan_pipeline, "_LANES", {})
    out, line, tap = scan_tree(tmp_path / "card", case, pattern, shards, False, monkeypatch,
                           device="cuda:0")
    want_out, want_line, want = scan_tree(tmp_path / "cpu", case, pattern, shards, False,
                                      monkeypatch)
    assert out == want_out and out.count(b"\n") > 100
    for got, exp in ((tap.bufs, want.bufs), (tap.flags, want.flags)):
        assert [len(l) for l in got] == [len(l) for l in exp]
        for got_lane, exp_lane in zip(got, exp):
            for g, w in zip(got_lane, exp_lane):
                assert np.array_equal(g, w)
    assert stats_field(line, "cand_blocks") == stats_field(want_line, "cand_blocks")
    assert tap.stale_claims >= 1
    batches = stats_field(line, "batches")
    assert batches >= 3 and stats_field(line, "inplace") == (batches if pattern == "linear" else 0)


@pytest.mark.gpu
def test_inplace_counts_every_batch_of_big_files(cuda, tmp_path, monkeypatch):
    """A literal scan of big files at the card's 32 MiB buffer: every
    batch is preread straight into its pinned upload slot."""
    import io
    import re

    from grab_tpu_torch import cli

    monkeypatch.setenv("GRAB_TPU_TORCH_DEVICE", "cuda")
    rng = np.random.default_rng(11)
    for i, mib in enumerate((40, 57, 9)):
        n = (mib << 20) + 777 * i
        data = rng.integers(97, 123, size=n, dtype=np.uint8)
        data[::97] = 10
        data[n - 40 : n - 32] = np.frombuffer(b"needleXY", dtype=np.uint8)
        (tmp_path / f"f{i}.log").write_bytes(data.tobytes())
    out, err = io.BytesIO(), io.StringIO()
    assert cli.main(["--stats", "-r", "needleXY", str(tmp_path)], out=out, err=err) == 0
    assert out.getvalue().count(b"needleXY") == 3
    line = err.getvalue()
    batches = int(re.search(r" batches=(\d+)", line)[1])
    assert batches >= 4 and f" inplace={batches} " in line
