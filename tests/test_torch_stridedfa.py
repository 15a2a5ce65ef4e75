"""The port's strided-DFA tier against the JAX package's.

Tables, the plain PyTorch walk (bitmap and exit states), the boundary
windows, the threading fixpoint (walks run, round cap included), the
scanner's decoded flags and the DeviceScanner's gdfa routing must equal
the reference's exactly (tolerance: exact — every output is integer
bits). The reference runs its Pallas kernel in interpret mode on the
CPU and its numpy oracle. The CUDA kernel itself runs only on the card:
tests/test_torch_gpu.py and chip_smoke.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grab_tpu.ops import pallas_stridedfa as ref
from grab_tpu.regex.compiler import compile_multi as ref_compile
from grab_tpu_torch.ops import stridedfa as port
from grab_tpu_torch.regex.compiler import compile_multi

STREAM_ROWS, LANES, N_STREAMS = 128, 128, 128 * 128

# one pattern per plan family the planner emits (tests/test_stridedfa.py)
FAMILIES = [
    (rb"[0-9]{5}", ("run", 4)),
    (rb"[0-9a-f]{4}", ("run", 2)),
    (rb"a[0-9]*b", ("run", 2)),
    (rb"needle|[a-z]{3}[0-9]{3}", ("run", 1)),
    (rb"[acegikmoqsuwy]{3}", ("runp", 2)),
    (rb"[adgjmpsvy]{3}", ("cls", 4)),
    (rb".{0,2}[a-z ]{11,}", ("cls", 2)),
    (rb".{0,2}[a-y]{200}", ("run16", 1)),
    (rb"[0-9]{200}", ("cls16", 2)),
    (rb"[acegikmoqsuwy]{150}", ("cls16", 2)),
    (rb"[0-9]{1500}", ("cls16", 1)),
]
FAMILY_IDS = [f"{p.decode()}-{m}{k}" for p, (m, k) in FAMILIES]
ALPHABET = np.frombuffer(b"0123456789abcdefgxyz acegikmoqsuwy \n-AZ\x80\xff", np.uint8)


@functools.lru_cache(maxsize=None)
def _tables(pattern):
    r = ref_compile([pattern]).dfa
    p = compile_multi([pattern]).dfa
    return ref.StrideDfaTables(r, ref.stride_plan(r)), port.StrideDfaTables(p, port.stride_plan(p))


def _stream_words(seed: int, n_words: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    raw = rng.choice(ALPHABET, size=(n_words * STREAM_ROWS, LANES, 4))
    return np.ascontiguousarray(raw).view("<i4").reshape(n_words * STREAM_ROWS, LANES)


@pytest.mark.parametrize("pattern,plan", FAMILIES, ids=FAMILY_IDS)
def test_tables_identical(pattern, plan):
    a, b = _tables(pattern)
    assert (a.mode, a.k) == (b.mode, b.k) == plan
    for f in ("m", "k", "mode", "thresholds", "acc_bit", "start", "n_rows", "n_states"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.tab.dtype == b.tab.dtype == np.int32 and np.array_equal(a.tab, b.tab)
    assert np.array_equal(a.flat, b.flat)


@pytest.mark.parametrize("pattern,plan", FAMILIES, ids=FAMILY_IDS)
def test_byte_index_is_the_kernels_per_byte_index(pattern, plan):
    """byte_index reproduces what the TPU kernel derives per byte: the
    threshold sum (run), run*2 + parity (runp), the packed class row
    (cls)."""
    a, b = _tables(pattern)
    byte = np.arange(256)
    if a.mode.startswith("cls"):
        pk = a.tab[-1].astype(np.int64)[byte & 127]
        want = (pk >> ((byte >> 7) << 3)) & 0xFF
    else:
        want = np.zeros(256, dtype=np.int64)
        for t in a.thresholds:
            want += byte >= t
        if a.mode.startswith("runp"):
            want = want * 2 + (byte & 1)
    assert np.array_equal(b.byte_index, want)
    assert b.byte_index.max() < b.m


WALK_FAMILIES = [FAMILIES[i] for i in (0, 1, 3, 4, 5, 6, 7, 8)]


@pytest.mark.parametrize("entries", ["start", "random"])
@pytest.mark.parametrize(
    "pattern,plan", WALK_FAMILIES, ids=[f"{p.decode()}-{m}{k}" for p, (m, k) in WALK_FAMILIES]
)
def test_plain_walk_matches_reference_kernel(pattern, plan, entries):
    """N_STREAMS * 32 bytes (8 word steps), start or random entries:
    the plain walk's (bm, exits) == the reference kernel in interpret
    mode == its numpy oracle."""
    a, b = _tables(pattern)
    w2d = _stream_words(len(pattern) + (entries == "random"), 8)
    rng = np.random.default_rng(7)
    if entries == "start":
        ent = np.full((STREAM_ROWS, LANES), a.start, np.int32)
    else:
        ent = rng.integers(0, a.n_states, (STREAM_ROWS, LANES), dtype=np.int32)
    bm_k, ex_k = ref.stride_dfa_scan(
        jnp.asarray(w2d), jnp.asarray(a.tab), jnp.asarray(ent),
        a.thresholds, a.m, a.k, mode=a.mode, interpret=True,
    )
    bm_np, ex_np = ref.np_stride_scan(w2d, a, ent)
    bm, ex = port.stride_dfa_scan(torch.from_numpy(w2d), b, torch.from_numpy(ent))
    assert bm.dtype == ex.dtype == torch.int32
    assert bm.shape == (8 * STREAM_ROWS // 16, LANES) and ex.shape == (STREAM_ROWS, LANES)
    assert np.array_equal(bm.numpy(), np.asarray(bm_k))
    assert np.array_equal(ex.numpy(), np.asarray(ex_k))
    assert np.array_equal(bm.numpy(), bm_np) and np.array_equal(ex.numpy(), ex_np)


@pytest.mark.parametrize("pattern,plan", FAMILIES, ids=FAMILY_IDS)
def test_plain_walk_matches_oracle_on_binary(pattern, plan):
    """Every plan family against the numpy oracle on arbitrary bytes
    (bytes >= 0x80 included) with random entries, 16 word steps."""
    a, b = _tables(pattern)
    rng = np.random.default_rng(len(pattern))
    raw = rng.integers(0, 256, (16 * STREAM_ROWS, LANES, 4), dtype=np.uint8)
    w2d = raw.view("<i4").reshape(16 * STREAM_ROWS, LANES)
    ent = rng.integers(0, a.n_states, (STREAM_ROWS, LANES), dtype=np.int32)
    bm_np, ex_np = ref.np_stride_scan(w2d, a, ent)
    bm, ex = port.stride_dfa_scan(torch.from_numpy(w2d), b, torch.from_numpy(ent))
    assert np.array_equal(bm.numpy(), bm_np) and np.array_equal(ex.numpy(), ex_np)


def _scanners(pattern, buf_size):
    rc, pc = ref_compile([pattern]), compile_multi([pattern])
    rs = ref.StrideDfaScanner(rc.dfa, rc.max_len, buf_size, interpret=True)
    ps = port.StrideDfaScanner(pc.dfa, pc.max_len, buf_size)
    return rs, ps


@pytest.mark.parametrize("buf_size", [N_STREAMS * 32, 2 << 20, 32 << 20, 36 << 20, 1 << 20])
@pytest.mark.parametrize("pattern", [rb"[0-9]{5}", rb"[A-Z]{6}[0-9]{6}", rb"a[0-9]*b",
                                     rb".{0,2}[a-z ]{11}", rb"[0-9]{100}"])
def test_scanner_geometry_identical(pattern, buf_size):
    rs, ps = _scanners(pattern, buf_size)
    for f in ("stride", "window_mode", "win_wb", "probe_back", "probe_fwd"):
        assert getattr(rs, f) == getattr(ps, f), f


def test_prep_t_and_windows_identical():
    rs, ps = _scanners(rb"[0-9]{5}", 2 << 20)
    rng = np.random.default_rng(3)
    buf = rng.integers(0, 256, size=(2 << 20) - 777, dtype=np.uint8)  # short: zero tail
    want = rs.prep_t(buf)
    got = ps.prep_t(buf)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    out = np.empty((ps.s_w, N_STREAMS), np.int32)
    assert np.array_equal(ps.prep_t(buf, out=out), want)
    assert np.array_equal(out.reshape(want.shape), want)
    # the window slices: the reference builds them inside run_t
    import jax

    wb, s_w = rs.win_wb, rs.stride // 4
    w2d = jnp.asarray(want)
    w1 = w2d[(s_w - wb) * STREAM_ROWS :]
    head = w2d[: wb * STREAM_ROWS].reshape(wb, N_STREAMS)
    w2 = jax.numpy.concatenate([head[:, 1:], jnp.zeros((wb, 1), w2d.dtype)], axis=1)
    ref_win = np.concatenate([np.asarray(w1), np.asarray(w2).reshape(wb * STREAM_ROWS, LANES)])
    assert np.array_equal(ps.windows_t(torch.from_numpy(want)).numpy(), ref_win)


def _ref_run(rs, buf):
    bm, n, conv = rs.traceable_run.run_t(jnp.asarray(rs.prep_t(buf)))
    return np.asarray(bm), int(n), bool(conv)


def _port_run(ps, buf):
    bm, n, conv = ps.run_t(torch.from_numpy(ps.prep_t(buf)))
    return bm.numpy(), int(n), bool(conv)


def _compare_scanners(pattern, buf, buf_size):
    rs, ps = _scanners(pattern, buf_size)
    want, got = _ref_run(rs, buf), _port_run(ps, buf)
    assert np.array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    nb = buf_size // 512
    flags = ps.flags_np(got[0], nb)
    assert np.array_equal(flags, rs.flags_np(want[0], nb))
    return ps, got, flags


def test_window_mode_identical():
    """Bounded pattern: main walk + boundary-window pass; a match across
    a stream boundary and one across the buffer's last boundary."""
    buf_size = N_STREAMS * 32
    buf = np.full(buf_size, ord("x"), dtype=np.uint8)
    for pos in (62, 4000, 100_001, buf_size - 3):
        buf[pos : pos + 5] = np.frombuffer(b"12345"[: buf_size - pos], dtype=np.uint8)
    ps, (bm, n, conv), flags = _compare_scanners(rb"[0-9]{5}", buf, buf_size)
    assert ps.window_mode and n == 1 and conv
    assert bm.shape[0] == (ps.s_w + 2 * ps.win_wb) * STREAM_ROWS // 16
    assert flags[0] == 1 and flags[4000 // 512] == 1


def test_threading_fixpoint_identical():
    """Unbounded pattern: runs crossing stream boundaries, one longer
    than several strides; walks run and the bitmap equal the
    reference's while_loop."""
    buf_size = N_STREAMS * 32
    buf = np.full(buf_size, ord(" "), dtype=np.uint8)
    for start, end in ((50, 77), (1000, 1100), (9000, 9600), (buf_size - 40, buf_size - 1)):
        buf[start] = ord("a")
        buf[start + 1 : end] = ord("7")
        buf[end] = ord("b")
    ps, (bm, n, conv), flags = _compare_scanners(rb"a[0-9]*b", buf, buf_size)
    assert not ps.window_mode and conv and n >= 2
    assert flags[77 // 512] == 1 and flags[9600 // 512] == 1
    assert flags.sum() < buf_size // 512


def test_threading_round_cap_identical(monkeypatch):
    """MAX_ROUNDS reached without convergence: an all-ones bitmap, every
    block flagged, on both sides."""
    monkeypatch.setattr(ref, "MAX_ROUNDS", 2)
    monkeypatch.setattr(port, "MAX_ROUNDS", 2)
    buf_size = N_STREAMS * 32
    buf = np.full(buf_size, ord(" "), dtype=np.uint8)
    buf[100] = ord("a")
    buf[101:400] = ord("7")  # crosses several 32-byte strides
    buf[400] = ord("b")
    ps, (bm, n, conv), flags = _compare_scanners(rb"a[0-9]*b", buf, buf_size)
    assert n == 2 and not conv and (bm == -1).all()
    assert flags.sum() == buf_size // 512


def test_fixpoint_plain_matches_per_walk_loop():
    """stride_dfa_fixpoint on the CPU is the reference's loop written
    out: walk from start, thread, walk again until the entries repeat."""
    pc = compile_multi([rb"a[0-9]*b"])
    t = port.StrideDfaTables(pc.dfa, port.stride_plan(pc.dfa))
    w2d = torch.from_numpy(_stream_words(11, 8))
    bm, n, conv = port.stride_dfa_fixpoint(w2d, t)
    e = torch.full((STREAM_ROWS, LANES), t.start, dtype=torch.int32)
    walks = 0
    while True:
        bm2, ex = port.stride_dfa_scan(w2d, t, e)
        walks += 1
        nxt = port.thread_entries(ex, t.start)
        if torch.equal(nxt, e):
            break
        e = nxt
    assert (n, conv) == (walks, True) and torch.equal(bm, bm2)


# -- the fixpoint kernel's round protocol (csrc/stridedfa.cu fixpoint_kernel)

KERNEL_TILES, KERNEL_THREADS = 256, 512  # 64-stream tiles (8 rows x 8 lanes), threads a block


def _tile_streams(blk: int) -> np.ndarray:
    rg, cg = divmod(blk, LANES // 8)
    r = rg * 8 + np.arange(8)[:, None]
    c = cg * 8 + np.arange(8)[None, :]
    return (r * LANES + c).reshape(-1)


def fixpoint_protocol_model(w2d, tables, max_rounds, grid, seed):
    """A numpy model of the fixpoint kernel, phase by phase, with the
    blocks of each phase taken in a shuffled order (blocks run in no
    order between grid syncs): physical block j walks tiles j, j + grid,
    ...; after round 0 a tile is walked again only if the entry of one of
    its streams differs from the one its last walk started from (the
    checkpoint), else its bitmap bytes and exits stand; the threading
    is grid-stride over the streams by global thread index, a block that
    changed an entry sets the round parity's word, block 0 zeroes the
    next parity's word; the round words start as garbage and the kernel
    zeroes both before its first sync. A tile's walk is the reference's
    numpy walk of its streams (streams are independent given their
    entries). → (bm, walks run, converged) as the kernel leaves them."""
    rng = np.random.default_rng(seed)
    start = tables.start
    s_w = w2d.shape[0] // STREAM_ROWS
    bm = np.full((s_w * STREAM_ROWS // 16, LANES), 0x5A5A5A5A, np.int32)  # garbage
    bm_bytes = bm.view(np.uint8).reshape(s_w, 8, LANES, 4)
    exits = np.full(N_STREAMS, -7, np.int64)
    walked_from = np.full(N_STREAMS, -7, np.int64)  # each stream's checkpoint 0
    ent = np.full(N_STREAMS, -7, np.int64)
    state = np.array([-7, -7, 1, 1], np.int64)
    state[2:4] = 0
    n = 0
    while True:
        entries = np.full(N_STREAMS, start, np.int64) if n == 0 else ent.copy()
        full_bm, full_ex = ref.np_stride_scan(w2d, tables, entries.reshape(STREAM_ROWS, LANES))
        full_bytes = full_bm.view(np.uint8).reshape(s_w, 8, LANES, 4)
        full_ex = full_ex.reshape(-1)
        for j in rng.permutation(grid):
            for blk in range(j, KERNEL_TILES, grid):
                ss = _tile_streams(blk)
                if n > 0 and (entries[ss] == walked_from[ss]).all():
                    continue
                rg, cg = divmod(blk, LANES // 8)
                lanes = slice(cg * 8, cg * 8 + 8)
                bm_bytes[:, rg // 2, lanes, rg % 2] = full_bytes[:, rg // 2, lanes, rg % 2]
                if n == 0 and rg % 2 == 0:
                    bm_bytes[:, rg // 2, lanes, 2:] = 0
                exits[ss] = full_ex[ss]
                walked_from[ss] = entries[ss]
        word = 2 + (n & 1)
        for j in rng.permutation(grid):
            moved = False
            for t in range(KERNEL_THREADS):
                for s in range(j * KERNEL_THREADS + t, N_STREAMS, grid * KERNEL_THREADS):
                    v = start if s == 0 else exits[s - 1]
                    moved |= v != (start if n == 0 else ent[s])
                    ent[s] = v
            if moved:
                state[word] = 1
            if j == 0:
                state[2 + ((n + 1) & 1)] = 0
        n += 1
        converged = state[word] == 0
        if converged or n >= max_rounds:
            break
    if not converged:
        bm[:] = -1
    return bm, n, bool(converged)


def _fixpoint_buffer(kind):
    buf_size = N_STREAMS * 32  # the scanner's least geometry: 32 word steps, 128-byte strides
    if kind == "a[0-9]*b":
        # the in-digits state crosses one stream a walk: 1000-1500 takes 5+ walks
        buf = np.full(buf_size, ord(" "), dtype=np.uint8)
        for start, end in ((50, 200), (1000, 1500), (buf_size - 40, buf_size - 1)):
            buf[start] = ord("a")
            buf[start + 1 : end] = ord("7")
            buf[end] = ord("b")
        return rb"a[0-9]*b", buf
    rng = np.random.default_rng(5)  # one Q a stream: the guess-defeating automaton
    buf = rng.choice(np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8), size=buf_size)
    buf[3::128] = ord("Q")
    return rb"Q(?:[a-z]{2})*Q", buf


@functools.lru_cache(maxsize=None)
def _ref_fixpoint(kind):
    """kind's buffer, the two scanners, and the reference's run_t (in
    interpret mode) jitted once with its round cap as a traced argument:
    run_t reads its module's MAX_ROUNDS when it traces its while_loop's
    cond, so setting it to the tracer for that trace gives the same code
    with the cap as an input, and the round caps share one compile."""
    import jax

    pattern, buf = _fixpoint_buffer(kind)
    rs, ps = _scanners(pattern, buf.size)

    def run_t(w2d, max_rounds):
        keep = ref.MAX_ROUNDS
        ref.MAX_ROUNDS = max_rounds
        try:
            return rs.traceable_run.run_t(w2d)
        finally:
            ref.MAX_ROUNDS = keep

    return buf, rs, ps, jax.jit(run_t)


@pytest.mark.parametrize("max_rounds", [1, 2, 24])
@pytest.mark.parametrize("kind", ["a[0-9]*b", "Q(?:[a-z]{2})*Q"])
def test_fixpoint_protocol_model_matches_reference(monkeypatch, kind, max_rounds):
    """The model of the fixpoint kernel's rounds, at the full grid and at
    grids smaller than the 256 tiles (100, and 7: blocks of several
    tiles), gives the reference run_t's (bm, walks, converged), in
    interpret mode, and so does the port's plain fixpoint; the round cap
    leaves the all-ones bitmap."""
    monkeypatch.setattr(port, "MAX_ROUNDS", max_rounds)
    buf, rs, ps, ref_run_t = _ref_fixpoint(kind)
    assert not rs.window_mode and not ps.window_mode
    w2d = rs.prep_t(buf)
    bm, n, conv = ref_run_t(jnp.asarray(w2d), jnp.int32(max_rounds))
    want = np.asarray(bm), int(n), bool(conv)
    got = _port_run(ps, buf)
    assert got[1:] == want[1:] and np.array_equal(got[0], want[0])
    for grid in (KERNEL_TILES, 100, 7):
        bm, n, conv = fixpoint_protocol_model(w2d, rs.tables, max_rounds, grid, seed=grid)
        assert (n, conv) == want[1:], grid
        assert np.array_equal(bm, want[0]), grid
    assert want[1] <= max_rounds and (want[2] or (want[0] == -1).all())
    # the entries move after the first walk here; a[0-9]*b takes 5+ walks
    assert want[2] == (max_rounds == 24) or (kind != "a[0-9]*b" and max_rounds == 2)


@pytest.mark.parametrize(
    "bad",
    [
        lambda w, e: (w[:, :64], e),  # wrong lane count
        lambda w, e: (w[:100], e),  # rows not a multiple of 128
        lambda w, e: (w.to(torch.int64), e),  # wrong dtype
        lambda w, e: (w, e[:64]),  # wrong entries shape
    ],
)
def test_wrappers_reject_bad_geometry(bad):
    pc = compile_multi([rb"[0-9]{5}"])
    t = port.StrideDfaTables(pc.dfa, port.stride_plan(pc.dfa))
    w = torch.zeros((8 * STREAM_ROWS, LANES), dtype=torch.int32)
    e = torch.zeros((STREAM_ROWS, LANES), dtype=torch.int32)
    w2, e2 = bad(w, e)
    with pytest.raises(ValueError):
        port.stride_dfa_scan(w2, t, e2)


# -- the kernel's segment geometry (csrc/stridedfa.cu mirrors it) ---------


@pytest.mark.parametrize("s_w", [1, 5, 8, 13, 32, 64, 77, 128, 512, 513, 1024, 5000])
def test_segment_geometry(s_w):
    """Tiles of SEGMENTS segments cover the word steps once, a segment
    holds at most SEG_MAX words (its hits fit 64 bits), a checkpoint
    every CKPT words, and the scratch is one int32 per checkpoint and
    stream."""
    seg, tiles, n_ck, scratch = port.segment_geometry(s_w)
    assert 1 <= seg <= port.SEG_MAX <= 64
    assert (tiles - 1) * port.SEGMENTS * seg < s_w <= tiles * port.SEGMENTS * seg
    assert seg == min(port.SEG_MAX, -(-s_w // port.SEGMENTS))
    assert (n_ck - 1) * port.CKPT < seg <= n_ck * port.CKPT
    assert scratch == tiles * port.SEGMENTS * n_ck * N_STREAMS
    assert port.WARM <= port.CKPT  # the warm-up is one chunk


def test_segment_geometry_of_the_main_buffer():
    """32 MiB: 512 word steps = one tile of 8 segments of 64 words, a
    4 MiB checkpoint scratch; the longest chain is a segment and its
    warm-up."""
    assert port.segment_geometry(512) == (64, 1, 8, (4 << 20) // 4)
    assert [port.chain_links(512, k) for k in (4, 2, 1)] == [72, 144, 288]
    assert port.chain_links(1024, 2) == 2 * 144  # two tiles in turn
    assert port.chain_links(5, 2) == (1 + 5) * 2


@pytest.mark.parametrize("s_w", [0, -3])
def test_segment_geometry_rejects_bad_steps(s_w):
    with pytest.raises(ValueError):
        port.segment_geometry(s_w)


def test_fixup_words_is_zero_on_the_cpu():
    """The plain walk has no fix-up: nothing to count, no device."""
    assert port.fixup_words(torch.device("cpu")) == 0
    assert port.fixup_words(torch.device("cpu"), reset=True) == 0


@pytest.mark.parametrize("entries", ["start", "random"])
@pytest.mark.parametrize("s_w", [8, 13])
def test_plain_walk_non_synchronising(s_w, entries):
    """Q(?:[a-z]{2})*Q over one Q per stream and lowercase letters: the
    state carries the parity since the Q (a guess from the start state
    never has it, the kernel's worst case); the plain walk equals the
    reference's numpy oracle, at word-step counts that are and are not
    a multiple of the segment count."""
    a, b = _tables(rb"Q(?:[a-z]{2})*Q")
    assert (b.mode, b.k) == ("run", 2) and b.n_states == 4
    rng = np.random.default_rng(s_w)
    raw = rng.choice(np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8), size=(N_STREAMS, 4 * s_w))
    raw[:, 0] = ord("Q")
    w2d = np.ascontiguousarray(raw.reshape(-1).view("<i4").reshape(N_STREAMS, s_w).T)
    w2d = w2d.reshape(s_w * STREAM_ROWS, LANES)
    if entries == "start":
        ent = np.full((STREAM_ROWS, LANES), a.start, np.int32)
    else:
        ent = rng.integers(0, a.n_states, (STREAM_ROWS, LANES), dtype=np.int32)
    bm_np, ex_np = ref.np_stride_scan(w2d, a, ent)
    bm, ex = port.stride_dfa_scan(torch.from_numpy(w2d), b, torch.from_numpy(ent))
    assert np.array_equal(bm.numpy(), bm_np) and np.array_equal(ex.numpy(), ex_np)
    # one Q per stream closes a match only from an entry inside one
    assert bm_np.any() == (entries == "random")


# -- DeviceScanner routing: modes, member types and flags ------------------

ROUTES = [
    (rb"[A-Z]{6}[0-9]{6}", "class_seq", "_StrideSeqMember"),
    (rb"[0-9]{5}", "class_seq", "_StrideSeqMember"),
    (rb"\t[0-9]+\t", "class_seq", "ClassSeqScanner"),
    (rb"[0-9]{12,}", "class_seq", "ClassSeqScanner"),
    (rb"n[a-z]+e", "class_seq", "ClassSeqScanner"),
    (rb"[0-9]{1500}", "class_seq", "ClassSeqScanner"),
    (rb".{0,2}(?:[0-9a-zA-Z]{4})+", "gdfa", "StrideDfaScanner"),
    (rb".{0,2}[a-z ]{11}", "gdfa", "StrideDfaScanner"),
    (rb".{0,2}[a-z ]{11,}", "gdfa", "StrideDfaScanner"),
    (rb"linus", "literal", "CoreWordScanner"),
]


@pytest.mark.parametrize("pattern,mode,member", ROUTES, ids=[r[0].decode() for r in ROUTES])
def test_device_scanner_routes_like_reference(pattern, mode, member):
    from grab_tpu.scan_pipeline import DeviceScanner as RefScanner
    from grab_tpu_torch.scan_pipeline import DeviceScanner

    r = RefScanner(ref_compile([pattern]), buf_size=2 << 20, pallas_interpret=True)
    p = DeviceScanner(compile_multi([pattern]), buf_size=2 << 20, devices=["cpu"])
    assert r.mode == p.mode == mode
    got = type(p.members[0]).__name__
    want = type(r._gdfa).__name__ if r.mode == "gdfa" else type(r._cw_list[0]).__name__
    assert got == want == member
    if mode == "gdfa":
        assert r._gdfa.window_mode == p._gdfa.window_mode


def test_device_scanner_gdfa_flags_match_reference():
    """gdfa, threading: the port's resolve == the reference DeviceScanner
    (Pallas interpret mode) on one 2 MiB packer buffer of the
    punctuation corpus of tests/test_exact_unbounded_device.py."""
    from grab_tpu.scan_pipeline import DeviceScanner as RefScanner
    from grab_tpu_torch.scan_pipeline import DeviceScanner

    pat = rb".{0,2}(?:[0-9a-zA-Z]{4})+"
    rng = np.random.default_rng(5)
    buf = rng.choice(np.frombuffer(b" -_=+()\n", dtype=np.uint8), size=(2 << 20) + 4096)
    buf[(2 << 20):] = 0
    for pos, span in ((5000, 8), (131030, 300), (524288 - 10, 5000), (900001, 4)):
        buf[pos : pos + span] = np.frombuffer((b"a1B2" * (span // 4 + 1))[:span], np.uint8)
    r = RefScanner(ref_compile([pat]), buf_size=2 << 20, pallas_interpret=True)
    p = DeviceScanner(compile_multi([pat]), buf_size=2 << 20, devices=["cpu"])
    want = r.resolve(r.submit(buf))
    got = p.scan(buf)
    assert got.dtype == want.dtype and np.array_equal(got, want) and got.sum() > 0


@pytest.mark.parametrize(
    "pattern,buf_size,item",
    [  # item: the ROADMAP item whose landing serves the plan (refused before it)
        (rb".{0,2}(?:[a-f][0-9][g-m][A-F][N-Z]){200}", 2 << 20, "ROADMAP A6"),
        (rb".{0,2}[a-z ]{11,}", 512 << 10, "ROADMAP A6"),
        (rb".{0,2}[0-9]{11}", 2 << 20, "ROADMAP A7"),
    ],
)
def test_plan_refusal_names_item(pattern, buf_size, item):
    """No single-device plan is refused any more: the plans that the
    last-resort walk (A6) and the alphabet-run tier (A7) brought build
    the reference's mode and member; only a pattern without any device
    form raises, as in the reference."""
    from grab_tpu.scan_pipeline import DeviceScanner as RefScanner
    from grab_tpu_torch.scan_pipeline import DeviceScanner, plan_refusal

    cp = compile_multi([pattern])
    assert plan_refusal(cp) is None
    p = DeviceScanner(cp, buf_size=buf_size, devices=["cpu"])
    r = RefScanner(ref_compile([pattern]), buf_size=buf_size, pallas_interpret=True)
    assert p.mode == r.mode == {"ROADMAP A6": "dfa", "ROADMAP A7": "alpha"}[item]
    want = {"dfa": "DfaWalkMember", "alpha": "AlphaRunScanner"}[p.mode]
    assert type(p.members[0]).__name__ == want
    if p.mode == "alpha":
        assert type(r._cw_list[0]).__name__ == want
    no_form = compile_multi([rb"(.)\1"])  # a backreference and no class run
    assert plan_refusal(no_form) is not None
    with pytest.raises(ValueError, match="no device-scannable form"):
        DeviceScanner(no_form, buf_size=buf_size, devices=["cpu"])


# -- the device-side relayout and the linear-words entries ---------------------


@pytest.mark.parametrize("s_w", [32, 128, 640])
def test_stride_transpose_matches_reference(s_w):
    """stride_transpose == the reference's tiled relayout (interpret
    mode) == the definition out[g*128 + r, c] = a[r*128 + c, g]."""
    rng = np.random.default_rng(s_w)
    a = rng.integers(-(1 << 31), 1 << 31, size=(N_STREAMS, s_w), dtype=np.int64).astype(np.int32)
    want = np.asarray(ref.stride_transpose(jnp.asarray(a), s_w, interpret=True))
    got = port.stride_transpose(torch.from_numpy(a), s_w)
    assert got.dtype == torch.int32 and got.shape == (s_w * STREAM_ROWS, LANES)
    assert got.is_contiguous() and np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy().reshape(s_w, N_STREAMS), a.T)


@pytest.mark.parametrize(
    "bad",
    [
        lambda a: (a[:, :31], 31),  # s_w not a multiple of 32
        lambda a: (a[:100], 32),  # not N_STREAMS rows
        lambda a: (a.to(torch.int64), 32),  # wrong dtype
        lambda a: (a, 64),  # s_w does not match the shape
    ],
)
def test_stride_transpose_rejects_bad_geometry(bad):
    a = torch.zeros((N_STREAMS, 32), dtype=torch.int32)
    with pytest.raises(ValueError):
        port.stride_transpose(*bad(a))


def _planted(buf_size, plants, fill=ord("x"), tail=0):
    buf = np.full(buf_size - tail, fill, dtype=np.uint8)
    for pos, s in plants:
        n = min(len(s), buf.shape[0] - pos)
        buf[pos : pos + n] = np.frombuffer(s[:n], dtype=np.uint8)
    return buf


LINEAR_CASES = [  # (pattern, buffer size, planted hits across stream boundaries)
    (rb"[0-9]{5}", N_STREAMS * 32, [(62, b"12345"), (4000, b"12345"), (100_001, b"12345")]),
    (rb".{0,2}[a-z ]{11}", 2 << 20, [(128 * 7 - 5, b"hello world"), (300_000, b"abc def ghij")]),
    (rb"a[0-9]*b", N_STREAMS * 32, [(50, b"a" + b"7" * 26 + b"b"), (9000, b"a" + b"7" * 599 + b"b")]),
]


@pytest.mark.parametrize("pattern,buf_size,plants", LINEAR_CASES,
                         ids=[c[0].decode() for c in LINEAR_CASES])
def test_run_on_linear_words_identical(pattern, buf_size, plants):
    """run(words) on the linear buffer == run_t(prep_t(buf)) == the
    reference's traceable_run(words), window mode and threading; a short
    buffer is zero-padded by prep."""
    rs, ps = _scanners(pattern, buf_size)
    fill = ord(" ") if pattern == rb"a[0-9]*b" else ord("X")
    buf = _planted(buf_size, plants, fill=fill, tail=777)
    words = ps.prep(buf)
    assert np.array_equal(words, rs.prep(buf))
    bm, n, conv = ps.run(torch.from_numpy(words.copy()))
    bm_t, n_t, conv_t = ps.run_t(torch.from_numpy(ps.prep_t(buf)))
    assert torch.equal(bm, bm_t) and (int(n), bool(conv)) == (int(n_t), bool(conv_t))
    bm_r, n_r, conv_r = rs.traceable_run(jnp.asarray(words))
    assert np.array_equal(bm.numpy(), np.asarray(bm_r))
    assert (int(n), bool(conv)) == (int(n_r), bool(conv_r))
    a2 = torch.from_numpy(words.copy()).reshape(N_STREAMS, ps.s_w)
    assert torch.equal(ps.run2d(a2)[0], bm)
    total, bm_p = ps.packed(torch.from_numpy(words.copy()))
    assert int(total) == int(torch.count_nonzero(bm)) > 0 and torch.equal(bm_p, bm)
    with pytest.raises(ValueError):
        ps.run(torch.from_numpy(words[:-1].copy()))


@pytest.mark.parametrize("buf_size", [2 << 20, (2 << 20) + (64 << 10)])
def test_stride_seq_member_packed_matches_reference(buf_size):
    """_StrideSeqMember.packed on the shared linear upload (the words
    with their pad rows) gives the reference member's total, bitmap and
    flags, and the same as packed_t on the born-transposed buffer; the
    second size is cut and zero-padded to the walk's geometry."""
    from grab_tpu.scan_pipeline import _StrideSeqMember as RefMember
    from grab_tpu_torch.scan_pipeline import _StrideSeqMember

    pats = [rb"[A-Z]{6}[0-9]{6}", rb"[0-9]{3}[a-z]{2}"]
    rc, pc = ref_compile(pats), compile_multi(pats)
    rm = RefMember(rc.seq_dfa, rc.seq_max_len, buf_size, True)
    pm = _StrideSeqMember(pc.seq_dfa, pc.seq_max_len, buf_size)
    assert (rm.rows, rm.need_w) == (pm.rows, pm.need_w)
    stride = pm.sc.stride
    plants = [(stride * 9 - 4, b"QWERTY123456"), (stride * 100 - 2, b"123ab"),
              (500_000, b"ABCDEF000001"), (buf_size - 5, b"999xy")]
    buf = _planted(buf_size, plants, fill=ord("."))
    words2d = np.zeros((buf_size // 512 + 8, LANES), dtype="<i4")
    words2d[: buf_size // 512] = buf.view("<i4").reshape(-1, LANES)
    t_r, pk_r = rm.packed(jnp.asarray(words2d))
    t_p, pk_p = pm.packed(torch.from_numpy(words2d))
    assert int(t_p) == int(t_r) > 0
    assert np.array_equal(pk_p.numpy().reshape(-1), np.asarray(pk_r))
    t_t, pk_t = pm.packed_t(torch.from_numpy(pm.prep_t(buf)))
    assert int(t_t) == int(t_p) and torch.equal(pk_t, pk_p)
    nb = buf_size // 512
    flags = pm.flags_np(pk_p.numpy(), nb)
    assert np.array_equal(flags, rm.flags_np(np.asarray(pk_r), nb))
    for pos, _s in plants[:3]:
        assert flags[pos // 512] == 1 or flags[(pos + 11) // 512] == 1
