"""The port's last-resort DFA walk against the JAX package's.

``expand_byte_table``, the kernel's class table, the multi-stream walk's
match-end bitmap, the per-block counts, the packed block flags of
``dfa_walk_flags`` and the DeviceScanner's "dfa" mode must equal the
reference's exactly (tolerance: exact — every output is an integer or a
bool). The JAX package computes this walk outside any Pallas kernel
(``lax.scan``, jitted); on the CPU the port's wrapper runs its plain
version, which is what these tests compare (the kernel itself, csrc/
dfa_walk.cu, is held against it in tests/test_torch_gpu.py and
chip_smoke.py).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grab_tpu.ops import dfa_scan as ref
from grab_tpu.regex.compiler import compile_multi as ref_compile
from grab_tpu_torch.ops import dfa_scan as port
from grab_tpu_torch.regex.compiler import compile_multi
from tests._torch_threads import _one_thread  # noqa: F401 (autouse: one intra-op thread)

NO_PLAN = rb".{0,2}(?:[a-f][0-9][g-m][A-F][N-Z]){200}"  # 1001 states, no stride plan
PATTERNS = [rb"needle", rb"[0-9]{3}-[0-9]{4}", rb".{0,2}[a-z ]{11,}", rb"a[0-9]*b",
            rb"\xff[\x80-\x9f]+\x00"]


@functools.lru_cache(maxsize=None)
def _dfas(pattern: bytes):
    """(the reference's DFA, the port's DFA) of one pattern, compiled once
    per test process."""
    return ref_compile([pattern]).dfa, compile_multi([pattern]).dfa


def _data(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ab0123456789-needl xyz\n\xff\x85\x00", np.uint8)
    buf = rng.choice(alpha, size=n)
    for pos, s in ((100, b"needle"), (n // 4 - 3, b"555-1234"), (n // 2 - 2, b"needle"),
                   (n - 6, b"needle"), (3 * n // 4 - 1, b"a12345b"),
                   (n // 8 - 4, b"hello world and more"), (2000, b"555-1234"),
                   (2100, b"\xff\x85\x85\x00"), (2200, b"a77b")):
        buf[pos : pos + len(s)] = np.frombuffer(s, np.uint8)
    return buf


@pytest.mark.parametrize("pattern", PATTERNS + [NO_PLAN], ids=lambda p: p.decode("latin-1")[:24])
def test_expand_byte_table_identical(pattern):
    r, p = _dfas(pattern)
    want = ref.expand_byte_table(r.table, r.class_map)
    got = port.expand_byte_table(p.table, p.class_map)
    assert got.dtype == want.dtype and got.shape == want.shape == (r.n_states, 256)
    assert np.array_equal(got, want) and got.flags["C_CONTIGUOUS"]


@pytest.mark.parametrize("n_streams,halo", [(8, 64), (4, 0), (1, 4096), (16, 4096), (32, 7)])
@pytest.mark.parametrize("pattern", PATTERNS, ids=lambda p: p.decode("latin-1")[:24])
def test_bitmap_matches_reference(pattern, n_streams, halo):
    dfa = ref_compile([pattern]).dfa
    n = 4096
    data = _data(len(pattern) + n_streams, n)
    table = ref.expand_byte_table(dfa.table, dfa.class_map)
    want = np.asarray(ref.dfa_scan_bitmap(
        jnp.asarray(table), jnp.asarray(dfa.accept_mask), jnp.int32(dfa.start),
        jnp.asarray(data), n_streams=n_streams, halo=halo))
    got = port.dfa_scan_bitmap(
        torch.from_numpy(table.astype(np.int32)), torch.from_numpy(np.asarray(dfa.accept_mask)),
        int(dfa.start), torch.from_numpy(data), n_streams=n_streams, halo=halo)
    assert got.dtype == torch.bool and got.shape == (n,)
    assert np.array_equal(got.numpy(), want) and want.any()
    for block in (512, 64):
        c_want = np.asarray(ref.bitmap_block_counts(jnp.asarray(want), block))
        c_got = port.bitmap_block_counts(got, block)
        assert c_got.dtype == torch.int32 and np.array_equal(c_got.numpy(), c_want)


def test_bitmap_rejects_ragged_streams():
    with pytest.raises(ValueError):
        port.dfa_scan_bitmap(torch.zeros((2, 256), dtype=torch.int32),
                             torch.zeros(2, dtype=torch.bool), 0,
                             torch.zeros(1000, dtype=torch.uint8), n_streams=7)


# -- DeviceScanner, dfa mode ------------------------------------------------

DFA_ROUTES = [
    (NO_PLAN, 64 << 10, 4096),  # no stride plan
    (rb".{0,2}[a-z ]{11,}", 64 << 10, 2048),  # a stride plan, buffer under 1 MiB
    (rb".{0,2}[a-z ]{11}", 128 << 10, 4096),
]


@pytest.mark.parametrize("pattern,buf_size,stream_seg", DFA_ROUTES,
                         ids=[p.decode()[:20] for p, _, _ in DFA_ROUTES])
def test_dfa_flags_match_reference(pattern, buf_size, stream_seg):
    """One packer buffer with planted matches: the port's scan == the
    reference DeviceScanner's (its jnp walk), same mode."""
    from grab_tpu.scan_pipeline import DeviceScanner as RefScanner
    from grab_tpu_torch.scan_pipeline import DeviceScanner

    r = RefScanner(ref_compile([pattern]), buf_size=buf_size, stream_seg=stream_seg,
                   pallas_interpret=True)
    p = DeviceScanner(compile_multi([pattern]), buf_size=buf_size, stream_seg=stream_seg,
                      devices=["cpu"])
    assert r.mode == p.mode == "dfa"
    member = p.members[0]
    assert type(member).__name__ == "DfaWalkMember"
    assert member.n_streams == r.n_streams == buf_size // stream_seg
    rng = np.random.default_rng(8)
    buf = rng.integers(48, 58, size=buf_size + 32 * 512, dtype=np.uint8)
    buf[buf_size:] = 0
    hit = (b"a1g" + b"AN") + b"".join(b"b2hBO" for _ in range(199))
    for pos in (777, buf_size // 2 - 500, buf_size - 1000 - 7):
        buf[pos : pos + len(hit)] = np.frombuffer(hit, np.uint8)
        buf[pos + 1100 : pos + 1114] = np.frombuffer(b"hello world ab", np.uint8)
    want = r.scan(buf)
    got = p.scan(buf)
    assert got.dtype == want.dtype and np.array_equal(got, want) and got.sum() > 0
    clean = np.full(buf_size, ord("-"), np.uint8)
    assert p.scan(clean).sum() == r.scan(clean).sum() == 0


# -- the kernel's tables and the wrapper (dfa_walk_flags) -----------------------


@pytest.mark.parametrize("pattern", PATTERNS + [NO_PLAN], ids=lambda p: p.decode("latin-1")[:24])
def test_walk_class_table_decodes_to_reference(pattern):
    """The class table (next state | accept bit) and the class map that
    csrc/dfa_walk.cu reads decode to the reference's byte table and
    accept mask."""
    r, p = _dfas(pattern)
    table, class_map = port.walk_class_table(p)
    assert table.dtype == np.uint16 and table.shape == (r.n_states, r.n_classes)
    assert class_map.dtype == np.uint8 and class_map.shape == (256,)
    want = ref.expand_byte_table(r.table, r.class_map)
    decoded = table[:, class_map]
    assert np.array_equal(decoded & 0x7FFF, want)
    accept = np.asarray(r.accept_mask, dtype=bool)
    assert np.array_equal((decoded >> 15).astype(bool), accept[want])
    assert accept[want].any()
    dev_table, dev_map = port.WalkTables(p).kernel_on(torch.device("cpu"))
    assert dev_table.numel() % 8 == 0 and np.array_equal(
        dev_table.numpy().view(np.uint16)[: table.size], table.reshape(-1))
    assert np.array_equal(dev_map.numpy(), class_map)


WALK_HIT = b"a1gAN" + b"b2hBO" * 199  # one match of NO_PLAN, 1000 bytes

# (buffer bytes, stream_seg): one stream; the 512 KiB route (16 streams of
# 32 KiB); 64 streams of 768 bytes (1.5 blocks each, halo 768)
WALK_GEOMETRIES = [(16 << 10, 32768), (512 << 10, 32768), (48 << 10, 768)]


def _walk_buffer(n: int, seg: int, seed: int) -> tuple:
    """Random bytes of both patterns' alphabets with NO_PLAN's match and
    11-letter runs planted across stream boundaries and in the halo.
    → (buffer, [(planted match, its end)] of those left whole)."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"a1gANb2hBOxyz ,.-Q", np.uint8)
    buf = rng.choice(alpha, size=n)
    spots = [(n // 2 - 6, b"hello world"), (n - len(WALK_HIT) - 12, b"abc def ghi")]
    for s in range(1, n // seg):
        b = s * seg
        if s % 2 and seg > 2 * len(WALK_HIT):
            spots.append((b - 300, WALK_HIT))  # ends in the next stream's head
        else:
            spots.append((b - 5, b"hello world"))  # across the boundary
    spots += [(100, WALK_HIT), (n - len(WALK_HIT), WALK_HIT)]
    for pos, hit in spots:
        buf[pos : pos + len(hit)] = np.frombuffer(hit, np.uint8)
    whole = [(hit, pos + len(hit) - 1) for pos, hit in spots
             if buf[pos : pos + len(hit)].tobytes() == hit]
    return buf, whole


def _reference_packed(dfa, data: np.ndarray, n_streams: int, halo: int) -> np.ndarray:
    """The JAX package's jitted walk → block counts > 0 → packed words."""
    bm = ref.dfa_scan_bitmap(
        jnp.asarray(ref.expand_byte_table(dfa.table, dfa.class_map)),
        jnp.asarray(dfa.accept_mask), jnp.int32(dfa.start), jnp.asarray(data),
        n_streams=n_streams, halo=halo)
    flags = np.asarray(ref.bitmap_block_counts(bm, 512)) > 0
    bits = flags.reshape(-1, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)
    return bits.sum(axis=1).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("pattern", [NO_PLAN, rb".{0,2}[a-z ]{11}"], ids=["no-plan", "a-z11"])
@pytest.mark.parametrize("n,stream_seg", WALK_GEOMETRIES, ids=["1-stream", "16x32K", "64x768"])
def test_walk_flags_match_reference(pattern, n, stream_seg):
    """DfaWalkMember.packed (dfa_walk_flags on a CPU tensor) == the
    reference's walk + block counts, packed; every planted match's end
    block is flagged; the CPU path launches no kernel."""
    dfa, p = _dfas(pattern)
    member = port.DfaWalkMember(p, n, 512, stream_seg, 0x1000)
    n_streams = max(1, n // stream_seg)
    assert member.n_streams == n_streams
    data, planted = _walk_buffer(n, n // n_streams, len(pattern) + n)
    want = _reference_packed(dfa, data, n_streams, 0x1000)
    before = port.dfa_walk_flags.launches
    total, packed = member.packed(torch.from_numpy(data))
    assert port.dfa_walk_flags.launches == before
    assert total.dtype == packed.dtype == torch.int32 and packed.shape == (n // 512 // 32,)
    assert np.array_equal(packed.numpy(), want)
    flags = member.flags_np(packed.numpy(), n // 512)
    assert int(total) == int(flags.sum()) > 0
    mine = [end for hit, end in planted if (hit == WALK_HIT) == (pattern == NO_PLAN)]
    assert len(mine) >= 2 and all(flags[end // 512] for end in mine)


def test_walk_rejects_ragged_geometry():
    """Streams that do not divide the buffer raise, in the member (112
    KiB: 3 streams of 32 KiB) and in the wrapper, as the reference's
    reshape does."""
    member = port.DfaWalkMember(_dfas(NO_PLAN)[1], 112 << 10, 512, 32768, 0x1000)
    assert member.n_streams == 3
    with pytest.raises(ValueError):
        member.packed(torch.zeros(112 << 10, dtype=torch.uint8))
    with pytest.raises(ValueError):
        port.dfa_walk_flags(torch.zeros(48 << 10, dtype=torch.uint8), member.tables, 7)
    with pytest.raises(ValueError):  # not whole 32-block groups
        port.dfa_walk_flags(torch.zeros(8 << 10, dtype=torch.uint8), member.tables, 1)


def _reference_counts(dfa, data: np.ndarray, n_streams: int, halo: int) -> np.ndarray:
    """The JAX package's jitted walk → per-block candidate counts."""
    bm = ref.dfa_scan_bitmap(
        jnp.asarray(ref.expand_byte_table(dfa.table, dfa.class_map)),
        jnp.asarray(dfa.accept_mask), jnp.int32(dfa.start), jnp.asarray(data),
        n_streams=n_streams, halo=halo)
    return np.asarray(ref.bitmap_block_counts(bm, 512))


@pytest.mark.parametrize("pattern", [NO_PLAN, rb".{0,2}[a-z ]{11}"], ids=["no-plan", "a-z11"])
@pytest.mark.parametrize("n,stream_seg", WALK_GEOMETRIES, ids=["1-stream", "16x32K", "64x768"])
def test_walk_counts_match_reference(pattern, n, stream_seg):
    """dfa_walk_counts on a CPU tensor (the sharded step's walk, plain)
    == the reference's walk + block counts; no kernel launch."""
    dfa, p = _dfas(pattern)
    n_streams = max(1, n // stream_seg)
    data, _ = _walk_buffer(n, n // n_streams, len(pattern) + n + 1)
    before = port.dfa_walk_counts.launches
    got = port.dfa_walk_counts(torch.from_numpy(data), port.WalkTables(p), n_streams, 0x1000)
    assert port.dfa_walk_counts.launches == before
    assert got.dtype == torch.int32 and got.shape == (n // 512,)
    assert np.array_equal(got.numpy(), _reference_counts(dfa, data, n_streams, 0x1000))
    assert int(got.sum()) > 0


# -- the kernel's segmented walk (csrc/dfa_walk.cu), modelled on the host -------

NON_SYNC = rb"Q(?:[a-z]{2})*Q"  # the parity of the letters since the last Q: never synchronises

# (buffer bytes, stream_seg) of every walk case of chip_smoke.py and
# tests/test_torch_gpu.py, a stream walked in two tiles, and 33,024-byte
# segments
SEGMENT_GEOMETRIES = [(2 << 20, 32768), (32 << 20, 32768), (512 << 10, 32768),
                      (2064 << 10, 32768), (48 << 10, 768), (16 << 10, 32768),
                      (128 << 10, 128 << 10)]


@pytest.mark.parametrize("n,stream_seg", SEGMENT_GEOMETRIES,
                         ids=lambda v: str(v))
def test_walk_geometry_covers_every_window_once(n, stream_seg):
    """walk_geometry (csrc/dfa_walk.cu make_geometry): each stream's
    segments cover its window [s*seg, min(N, (s+1)*seg + h)) exactly once,
    in order, each inside one 512-byte unit; the last stream stops at N;
    the longest window has p_max segments, walked in tiles of `tile`."""
    n_streams = max(1, n // stream_seg)
    geo = port.walk_geometry(n, n_streams, 0x1000, 512)
    assert geo.seg == n // n_streams and geo.h == min(0x1000, geo.seg)
    assert geo.seg_bytes == 512 and geo.chunk == 64
    longest = 0
    for s in range(n_streams):
        begin, end = geo.window(s)
        spans = geo.segments(s)
        assert spans[0][0] == begin and spans[-1][1] == end
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert all(lo < hi and lo // 512 == (hi - 1) // 512 for lo, hi in spans)
        longest = max(longest, len(spans))
    assert geo.window(n_streams - 1)[1] == n
    assert longest == geo.p_max and geo.tile == min(geo.p_max, port.TILE_MAX)
    assert geo.tiles == -(-geo.p_max // geo.tile)
    assert geo.record_words == n_streams * geo.p_max * 8
    if stream_seg == 32768 and n >= 1 << 20:
        assert geo.p_max == (73 if n == 2064 << 10 else 72) and geo.tiles == 1


def _walk_spans(table, accept, data, idx, state, lo, hi, base, ck, bits, chunk, rewalk):
    """Walks segments ``idx`` side by side from ``state`` over [lo, hi),
    as a kernel thread does: the state at the start of each chunk goes to
    ck[segment, chunk], each position's candidate bit to bits[segment,
    position - base]; a re-walk stops at the first chunk after its first
    whose checkpoint equals its state. → (states, merged, bytes walked)."""
    st = state.copy()
    merged = np.zeros(len(idx), dtype=bool)
    walked = np.zeros(len(idx), dtype=np.int64)
    lo, hi, base = lo[idx], hi[idx], base[idx]
    for off in range(bits.shape[1]):
        pos = base + off
        live = ~merged & (pos >= lo) & (pos < hi)
        first = live & (pos == lo)
        if off % chunk == 0 or first.any():
            bound = live & ~first & (off % chunk == 0)
            if rewalk:
                meet = bound & (ck[idx, off // chunk] == st)
                merged |= meet
                live &= ~meet
                bound &= ~meet
            mark = first | bound
            ck[idx[mark], off // chunk] = st[mark]
        nxt = table[st, data[np.clip(pos, 0, len(data) - 1)]]
        st = np.where(live, nxt, st)
        bits[idx[live], off] = accept[nxt[live]]
        walked += live
    return st, merged, walked


def _model_walk(dfa, data: np.ndarray, n_streams: int, halo: int = 0x1000):
    """The kernel's rule in numpy: every segment but a stream's first
    starts from its guess (the start state walked over the WARM bytes
    before it), then rounds re-walk each segment whose entry is not its
    predecessor's exit, with the checkpoint merge. → (candidate bitmap
    bool [N], re-walked bytes, rounds with a re-walk)."""
    n = len(data)
    geo = port.walk_geometry(n, n_streams, halo, 512)
    assert geo.tiles == 1
    table = ref.expand_byte_table(dfa.table, dfa.class_map).astype(np.int64)
    accept = np.asarray(dfa.accept_mask, dtype=bool)
    start = int(dfa.start)
    spans = [(s, p, lo, hi) for s in range(n_streams) for p, (lo, hi) in enumerate(geo.segments(s))]
    stream, pos_in, lo, hi = (np.array(c, dtype=np.int64) for c in zip(*spans))
    base = lo - lo % geo.seg_bytes
    begin = stream * geo.seg
    m = len(spans)
    everyone = np.arange(m)
    # the guesses: the start state over the WARM bytes before the segment
    entry = np.full(m, start, dtype=np.int64)
    for k in range(port.WARM):
        pos = lo - port.WARM + k
        live = (pos_in > 0) & (pos >= begin)
        entry = np.where(live, table[entry, data[np.clip(pos, 0, n - 1)]], entry)
    ck = np.zeros((m, geo.seg_bytes // geo.chunk), dtype=np.int64)
    bits = np.zeros((m, geo.seg_bytes), dtype=bool)
    exits, _, _ = _walk_spans(table, accept, data, everyone, entry, lo, hi, base, ck, bits,
                              geo.chunk, False)
    pred = np.where(pos_in > 0, everyone - 1, 0)
    rewalked = rounds = 0
    for _ in range(geo.tile + 1):
        into = np.where(pos_in > 0, exits[pred], start)
        stale = np.flatnonzero(into != entry)
        if not len(stale):
            break
        rounds += 1
        entry[stale] = into[stale]
        st, merged, walked = _walk_spans(table, accept, data, stale, into[stale], lo, hi, base,
                                         ck, bits, geo.chunk, True)
        exits[stale[~merged]] = st[~merged]
        rewalked += int(walked.sum())
    cand = np.zeros(n, dtype=bool)
    for i in range(m):
        cand[base[i] : base[i] + geo.seg_bytes] |= bits[i]
    return cand, rewalked, rounds


def _non_sync_buffer(n: int, seg: int, seed: int) -> np.ndarray:
    """Lowercase letters with one Q near the start of each stream, so
    every guess after it in the stream is wrong, and a few QxyQ."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(ord("a"), ord("z") + 1, size=n, dtype=np.uint8)
    buf[5::seg] = ord("Q")
    for pos in (100, n // 2 + 7, n - 4):
        buf[pos : pos + 4] = np.frombuffer(b"QxyQ", np.uint8)
    return buf


@pytest.mark.parametrize("pattern", [NO_PLAN, rb".{0,2}[a-z ]{11}", NON_SYNC],
                         ids=["no-plan", "a-z11", "non-sync"])
@pytest.mark.parametrize("n,stream_seg", [(512 << 10, 32768), (48 << 10, 768)],
                         ids=["16x32K", "64x768"])
def test_segmented_walk_model_is_exact(pattern, n, stream_seg):
    """The kernel's guess / fix-up / checkpoint rule, modelled in numpy
    over walk_geometry's segments, gives the plain walk's per-block
    counts and packed flags exactly, with planted matches across stream
    boundaries (guesses inside them are wrong) and with an automaton
    that never synchronises (every guess after a stream's Q is wrong)."""
    _, p = _dfas(pattern)
    n_streams = n // stream_seg
    seg = n // n_streams
    if pattern == NON_SYNC:
        data = _non_sync_buffer(n, seg, n + 3)
    else:
        data, _ = _walk_buffer(n, seg, len(pattern) + n)
    cand, rewalked, rounds = _model_walk(p, data, n_streams)
    counts = cand.reshape(-1, 512).sum(axis=1)
    want = port.dfa_walk_counts_torch(torch.from_numpy(data), port.WalkTables(p), n_streams)
    assert np.array_equal(counts, want.numpy()) and counts.sum() > 0
    total, packed = port.pack_block_flags(torch.from_numpy(counts.astype(np.int32)))
    want_total, want_packed = port.pack_block_flags(want)
    assert torch.equal(total, want_total) and torch.equal(packed, want_packed)
    if pattern == NON_SYNC:  # the fix-up walks every stream once more, a segment a round,
        # up to the next stream's Q, where the guess meets the true state
        assert rounds >= seg // 512 - 1 and rewalked > n // 2
    elif pattern == NO_PLAN and seg > 2 * len(WALK_HIT):  # guesses inside planted matches
        assert 0 < rewalked < n // 4


def test_fixup_bytes_is_zero_on_cpu():
    assert port.fixup_bytes(torch.device("cpu")) == 0
    assert port.fixup_bytes(torch.device("cpu"), reset=True) == 0
