"""The port's byte-level scans against the JAX package's jnp functions.

``literal_scan_bitmap``, ``class_prefilter_bitmap`` and
``make_sharded_scan`` run in plain PyTorch on the CPU; the reference's
jit-compiled jnp versions run on CPU JAX (the sharded step over a mesh
of the conftest's virtual CPU devices). Data comes from numpy seeds:
random text, planted hits, and hits cut off by the buffer's end.
Tolerance: 0 — booleans and integer counts, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grab_tpu.ops import class_prefilter as ref_cp
from grab_tpu.ops import dfa_scan as ref_dfa
from grab_tpu.ops import literal_scan as ref_ls
from grab_tpu.parallel.scan_step import make_mesh, make_sharded_scan as ref_sharded
from grab_tpu.regex import ast as ref_ast
from grab_tpu.regex.compiler import compile_pattern as ref_compile
from grab_tpu.regex.parser import parse as ref_parse
from grab_tpu.scan_pipeline import HALO
from grab_tpu_torch.ops import class_prefilter as port_cp
from grab_tpu_torch.ops import literal_scan as port_ls
from grab_tpu_torch.parallel.scan_step import make_sharded_scan as port_sharded
from grab_tpu_torch.regex import ast as port_ast
from grab_tpu_torch.regex.compiler import compile_pattern as port_compile
from grab_tpu_torch.regex.parser import parse as port_parse


def buffer(kind, n, seed, needles=()):
    """uint8 [n]: random printable text with newlines, random binary, or
    zeros; ``needles`` planted at (pos, bytes), cut off at the end."""
    rng = np.random.default_rng(seed)
    if kind == "text":
        data = rng.integers(32, 127, size=n, dtype=np.uint8)
        data[rng.random(n) < 0.02] = 0x0A
    elif kind == "binary":
        data = rng.integers(0, 256, size=n, dtype=np.uint8)
    else:
        data = np.zeros(n, dtype=np.uint8)
    for pos, s in needles:
        s = np.frombuffer(s, dtype=np.uint8)[: n - pos]
        data[pos : pos + len(s)] = s
    return data


LITERAL_SETS = [
    [b"needle"],
    [b"needleXYZlonger", b"ab", b"q"],  # capped at 8 bytes; 1- and 2-byte literals
    [b"ab\x00", b"\x00\x00", b"Zz9"],  # zero bytes: the zero tail can complete them
]


def planted(lits, n):
    """Every literal at the start, in the middle and cut off by the end
    of the buffer (its first byte in the last byte)."""
    out = []
    for i, lit in enumerate(lits):
        out += [(3 * i, lit), (n // 2 + 17 * i, lit), (n - 1 - i, lit), (n - len(lit) + 1, lit)]
    return out


@pytest.mark.parametrize("kind", ["text", "binary", "zeros"])
@pytest.mark.parametrize("lits", LITERAL_SETS, ids=["one", "capped", "zero-bytes"])
def test_literal_scan_bitmap_equal(kind, lits):
    n = 8191  # not a multiple of any word or block
    data = buffer(kind, n, 31, planted(lits, n))
    mat, lens = port_ls.literal_matrix(lits)
    ref_mat, ref_lens = ref_ls.literal_matrix(lits)
    assert (mat == ref_mat).all() and (lens == ref_lens).all()
    got = port_ls.literal_scan_bitmap(mat, tuple(int(x) for x in lens), torch.from_numpy(data))
    want = np.asarray(ref_ls.np_literal_scan_bitmap(lits, data))
    assert got.dtype == torch.bool and got.shape == (n,)
    assert np.array_equal(got.numpy(), want)
    if kind != "zeros":
        assert got.any()


CLASS_PATTERNS = [rb"\d+\.\d+", rb"[a-f]+xyz", rb"n[a-f]+le", rb"\w+@\w+", rb"[^\n]x[\x80-\xff]",
                  rb"(?s).a", rb"[aceg-ik-mo-qs-uw-y]{3}"]  # (?s). is 0..255; 9+ ranges


@pytest.mark.parametrize("kind", ["text", "binary", "zeros"])
@pytest.mark.parametrize("pattern", CLASS_PATTERNS, ids=repr)
def test_class_prefilter_bitmap_equal(kind, pattern):
    ref_seqs = ref_ast.prefix_class_sequences(ref_parse(pattern), 8)
    seqs = port_ast.prefix_class_sequences(port_parse(pattern), 8)
    assert seqs == ref_seqs and seqs
    compiled = port_cp.compile_sequences(seqs)
    assert compiled == ref_cp.compile_sequences(ref_seqs)
    n = 6000
    data = buffer(kind, n, 41, [(100, b"3.14 abcxyz x@y"), (n - 3, b"9.5"), (n - 2, b"bxyz"),
                                (2000, b"\x01x\x90 nacle")])
    got = port_cp.class_prefilter_bitmap(compiled, torch.from_numpy(data))
    want = np.asarray(ref_cp.np_class_prefilter_bitmap(ref_seqs, data))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)


def test_membership_full_range_is_true():
    plane = torch.tensor([0, 7, 255], dtype=torch.int32)
    assert port_cp._membership(plane, ((5, 9), (0, 255))).all()
    assert port_cp._membership(plane, ((7, 7),)).tolist() == [False, True, False]


SHARD = 64 << 10  # 2 DFA streams of 32 KiB per shard


def sharded_data(n_shards, seed, needle):
    n = n_shards * SHARD
    needles = [(d * SHARD + 100 + d, needle) for d in range(n_shards)]
    needles += [(d * SHARD - 3, needle) for d in range(1, n_shards)]  # across shards
    needles += [(n - 4, needle), (SHARD // 2 - 2, needle)]  # the end; across streams
    return buffer("text", n, seed, needles)


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("pattern,needle", [(rb"fooxyzzbar", b"fooxyzzbar"),
                                            (rb"[a-f]{3}[0-9]{4}", b"abc1234")],
                         ids=["literal", "dfa"])
def test_make_sharded_scan_equal(n_shards, pattern, needle):
    """One shard against the reference's one-device mesh, N shards on N
    CPU devices against the reference's per-shard results and psum. The
    reference's DFA step does not trace under this JAX's shard_map (its
    scan carry lacks the varying-axis cast), so for a pattern without a
    literal the reference side is its per-shard body: the jnp walk with
    the HALO overlap and its block counts, shard by shard."""
    cp, ref_cp_ = port_compile(pattern), ref_compile(pattern)
    assert cp.literals == ref_cp_.literals and bool(cp.literals) == (needle == pattern)
    data = sharded_data(n_shards, 51, needle)
    n_streams = max(1, SHARD // 32768)
    if cp.literals:
        from jax.sharding import NamedSharding, PartitionSpec as P

        mesh = make_mesh(n_shards)
        ref_counts, ref_total = ref_sharded(ref_cp_, mesh, SHARD)(
            jax.device_put(jnp.asarray(data), NamedSharding(mesh, P("shards"))))
    else:
        dfa = ref_cp_.dfa
        table = jnp.asarray(ref_dfa.expand_byte_table(dfa.table, dfa.class_map))
        per = [ref_dfa.bitmap_block_counts(
            ref_dfa.dfa_scan_bitmap(table, jnp.asarray(dfa.accept_mask), jnp.int32(dfa.start),
                                    jnp.asarray(data[d * SHARD : (d + 1) * SHARD]),
                                    n_streams=n_streams, halo=HALO), 512)
            for d in range(n_shards)]
        ref_counts = jnp.concatenate(per)
        ref_total = sum(int(c.sum()) for c in per)
    ref_counts = np.asarray(ref_counts)
    fn = port_sharded(cp, ["cpu"] * n_shards, SHARD)
    counts, total = fn(torch.from_numpy(data))
    assert len(counts) == n_shards and all(c.dtype == torch.int32 for c in counts)
    got = torch.cat(counts).numpy()
    assert np.array_equal(got, ref_counts)
    assert total.dtype == torch.int32 and int(total) == int(ref_total) >= n_shards
    with pytest.raises(ValueError):
        fn(torch.from_numpy(data[:-1]))


# -- the literal kernel's tables, filters and verify (csrc/literal_scan.cu) --

MASK32 = np.uint64(0xFFFFFFFF)


def lane_words(data: np.ndarray) -> np.ndarray:
    """uint64 [chunks, 32, 6]: per 512 bytes, lane l's 16 bytes as four
    little-endian words and the next 8 from lane l + 1 (lane 31 from the
    next 512 bytes, zero past the end: the reference's zero tail)."""
    words = data.view("<u4").reshape(-1, 32, 4).astype(np.uint64)
    nxt = np.zeros(words.shape[:2] + (2,), np.uint64)
    nxt[:, :31] = words[:, 1:, :2]
    nxt[:-1, 31] = words[1:, 0, :2]
    return np.concatenate([words, nxt], axis=2)


def funnel_r(lo, hi, s):
    """__funnelshift_r: the low word of (hi:lo) >> (s mod 32)."""
    return ((lo | hi << np.uint64(32)) >> (np.asarray(s, np.uint64) & np.uint64(31))) & MASK32


def prmt(a, b, sel: int):
    """PTX prmt.b32 (default mode): byte n of the result is byte sel[n] & 7
    of (b:a), or that byte's sign replicated when sel[n] & 8."""
    src = [(x >> np.uint64(8 * j)) & np.uint64(0xFF) for x in (a, b) for j in range(4)]
    out = np.zeros_like(a)
    for n in range(4):
        nib = sel >> 4 * n & 15
        byte = src[nib & 7]
        if nib & 8:
            byte = np.where(byte & np.uint64(0x80), np.uint64(0xFF), np.uint64(0))
        out |= byte << np.uint64(8 * n)
    return out


def window_at(w, i: int):
    """The kernel's window_at: the 8 bytes from byte i of each lane."""
    q, s = divmod(i, 4)
    return funnel_r(w[..., q], w[..., q + 1], 8 * s) | funnel_r(w[..., q + 1], w[..., q + 2],
                                                               8 * s) << np.uint64(32)


def blob_parts(t):
    """The table blob's arrays, read at the offsets the kernel reads."""
    blob = t.blob
    return (blob[:8192].view("<u4").astype(np.uint64), blob[8192:12288].view("<u2"),
            blob[12288:12320].view("<u4").astype(np.uint64),
            blob[t.off_at : t.off_at + 4 * (t.n_pairs + 1)].view("<i4"),
            blob[t.keys_at :].view("<u8").reshape(-1, 2))


def table_hits(w, keys):
    """The table form on every lane: per position the PRMT word index, the
    bitmap word, the rotate by b0 and the funnel into the candidate bits
    (bit 15 - i), then per candidate the first-byte table, the pair's
    rank and bucket and the masked compare. → hits [chunks, 32]."""
    bits, ranks, first, off, kv = blob_parts(keys.tables)
    cand = np.zeros(w.shape[:2], np.uint64)
    for q in range(4):
        x, y = w[..., q], funnel_r(w[..., q], w[..., q + 1], 8)
        h = (x >> np.uint64(5)) & np.uint64(0x07070707)
        for r in range(4):
            word = bits[prmt(y, h, r | (4 + r) << 4 | (12 + r) << 8 | (12 + r) << 12)]
            rot = funnel_r(word, word, x >> np.uint64(8 * r))
            cand = (cand << np.uint64(1) | rot >> np.uint64(31)) & MASK32
    hits = np.zeros(w.shape[:2], np.int64)
    for b in range(16):
        at = np.nonzero((cand >> np.uint64(b)) & np.uint64(1))
        win = window_at(w, 15 - b)[at]
        b0 = (win & np.uint64(0xFF)).astype(np.int64)
        b1 = ((win >> np.uint64(8)) & np.uint64(0xFF)).astype(np.int64)
        hit = ((first[b0 >> 5] >> (b0 & 31).astype(np.uint64)) & np.uint64(1)).astype(bool)
        wi = b1 | (b0 >> 5) << 8
        below = (np.uint64(1) << ((b0 + 31) & 31).astype(np.uint64)) - np.uint64(1)
        rank = ranks[wi].astype(np.int64) + np.bitwise_count(bits[wi] & below).astype(np.int64)
        lo, hi = off[rank].astype(np.int64), off[rank + 1].astype(np.int64)
        owner = np.repeat(np.arange(win.size), hi - lo)
        k = lo[owner] + np.arange(owner.size) - np.repeat(np.cumsum(hi - lo) - (hi - lo), hi - lo)
        match = (win[owner] & kv[k, 0]) == kv[k, 1]
        hit |= np.bincount(owner[match], minlength=win.size) > 0
        hits[at] += hit
    return hits


def swar_hits(w, keys):
    """The SWAR form on every lane: per word and key t = (x ^ c0) | ((y ^
    c1) & m1), flags (t - 0x01010101) & ~t, the flags packed as the
    kernel packs them (bit 8r + q: position 4q + r), and every flagged
    position verified against every key. → hits [chunks, 32]."""
    k = len(keys.lengths)
    c0, c1, m1 = keys.swar[:60].view("<u4").reshape(3, 5).astype(np.uint64)
    mask, value = keys.swar[64:].view("<u8").reshape(2, 5)
    cand = np.zeros(w.shape[:2], np.uint64)
    for q in range(4):
        x, y = w[..., q], funnel_r(w[..., q], w[..., q + 1], 8)
        f = np.zeros_like(x)
        for j in range(k):
            t = (x ^ c0[j]) | ((y ^ c1[j]) & m1[j])
            f |= ((t - np.uint64(0x01010101)) & MASK32) & ~t
        cand |= ((f >> np.uint64(7)) & np.uint64(0x01010101)) << np.uint64(q)
    hits = np.zeros(w.shape[:2], np.int64)
    for b in (8 * r + q for r in range(4) for q in range(4)):
        at = np.nonzero((cand >> np.uint64(b)) & np.uint64(1))
        win = window_at(w, 4 * (b & 7) + (b >> 3))[at]
        hits[at] += ((win[:, None] & mask[:k]) == value[:k]).any(axis=1)
    return hits


def literal_kernel_model(data: np.ndarray, keys, form: str, block: int = 512) -> np.ndarray:
    """A numpy model of the kernel in one form ("table" or "swar"), lane by
    lane as the warp holds the bytes. → int32 [N / block]."""
    w = lane_words(data)
    hits = table_hits(w, keys) if form == "table" else swar_hits(w, keys)
    return hits.reshape(data.size // block, -1).sum(axis=1).astype(np.int32)


def _text_lits(n, seed, lo, hi):
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(33, 127, size=int(rng.integers(lo, hi + 1)), dtype=np.uint8))
            for _ in range(n)]


W2_SETS = {  # 1-, 3-, 8- and 11-byte literals, a zero-length and NUL-ending ones
    "K1": [b"fooxyzzbar"],
    "K16": [b"q", b"fox", b"abcdefgh", b"needle-in-a", b"", b"ab\x00", b"xyz\x00\x00",
            b"\x00\x00\x00"] + [b"lit%02d-xy" % i for i in range(8)],
    "K300": [bytes(np.random.default_rng(i).integers(33, 127, size=1 + i % 11, dtype=np.uint8))
             for i in range(300)],
}
W2_MORE = {  # the redesign's own cases, on the buffers of w2_case_data
    "K1000": _text_lits(1000, 1000, 2, 11),
    "dense": list(dict.fromkeys(b"ab" + x for x in _text_lits(330, 301, 1, 9)))[:300],
    "short": [b"", b"q", b"~", b"\n", b"\xff"],  # capped lengths 0 and 1 only
    "binary": [b"\x00\xff", b"\xff\xff\x00", b"\x00\x00\x00", b"\xffab", b"\xff"],
    "zeros": [b"\x00\x00\x00\x00", b"ab", b"\x00a"],
}


def w2_data(lits, n, seed):
    """Text with sparse NULs, every literal planted across block edges
    and at random, and the buffer's last bytes the head of a NUL-ending
    literal (or a whole literal): a hit in the shard's last 7 bytes."""
    rng = np.random.default_rng(seed)
    data = buffer("text", n, seed)
    data[rng.integers(0, n, size=n // 500)] = 0
    for i, lit in enumerate(lits * max(1, 64 // len(lits))):
        pos = 512 * (i % (n // 512)) + 509 if i % 2 else int(rng.integers(0, n - 16))
        data[pos : pos + len(lit)] = np.frombuffer(lit, np.uint8)[: n - pos]
    nul_end = [l for l in lits if l.endswith(b"\x00") and l.strip(b"\x00")]
    tail = nul_end[0].rstrip(b"\x00") if nul_end else min(lits, key=len)
    data[n - len(tail) :] = np.frombuffer(tail, np.uint8)
    return data


def w2_case_data(case, n):
    """The model's buffer of a case: w2_data's text, but for "dense" text
    whose every 4 bytes start with ab (the 300 keys' shared pair), for
    "binary" random bytes with runs of 0x00 and 0xFF, for "zeros" zeros."""
    lits = {**W2_SETS, **W2_MORE}[case]
    if case == "zeros":
        return np.zeros(n, np.uint8)
    data = w2_data(lits, n, len(lits))
    rng = np.random.default_rng(n + len(lits))
    if case == "dense":
        data[0::4], data[1::4] = ord("a"), ord("b")
        for i, lit in enumerate(lits[:64]):
            pos = 512 * (i % (n // 512)) + 510 - 4 * (i % 3)
            data[pos : pos + len(lit)] = np.frombuffer(lit, np.uint8)[: n - pos]
    elif case == "binary":
        data = rng.integers(0, 256, size=n, dtype=np.uint8)
        for pos, run in zip(rng.integers(0, n - 40, size=60), rng.integers(1, 40, size=60)):
            data[pos : pos + run] = 0xFF if pos % 2 else 0
        for i, lit in enumerate(lits * 4):
            pos = 512 * (i + 1) - len(lit) // 2
            data[pos : pos + len(lit)] = np.frombuffer(lit, np.uint8)
        data[-2:] = 0xFF  # \xff\xff\x00 against the zero tail
    return data


def ref_block_counts(lits, data):
    """The reference's literal_scan_bitmap (run op by op: its jit would
    compile a K-literal graph) and bitmap_block_counts."""
    mat, lens = ref_ls.literal_matrix(lits)
    with jax.disable_jit():
        bm = ref_ls.literal_scan_bitmap(jnp.asarray(mat), tuple(int(x) for x in lens),
                                        jnp.asarray(data))
    return np.asarray(ref_dfa.bitmap_block_counts(bm, 512))


@pytest.mark.parametrize("case", sorted(W2_SETS) + sorted(W2_MORE))
def test_literal_kernel_model_equals_reference(case):
    """The host's tables and the model of the kernel, in the table form
    and (up to 5 keys) the SWAR form, give the reference
    literal_scan_bitmap's block counts."""
    lits = {**W2_SETS, **W2_MORE}[case]
    n = 16 << 10
    data = w2_case_data(case, n)
    keys = port_ls.LiteralKeys(lits)
    assert keys.mask.dtype == keys.value.dtype == np.uint64 and keys.mask.shape == (len(lits),)
    want = ref_block_counts(lits, data)
    forms = ["table"] + (["swar"] if len(lits) <= port_ls.SWAR_MAX else [])
    for form in forms:
        got = literal_kernel_model(data, keys, form)
        assert np.array_equal(got, want), form
    assert want[-1] > 0
    if case in ("K16", "short"):  # the zero-length literal hits every NUL byte
        assert want.sum() >= int((data == 0).sum())
    if case == "dense":  # a quarter of the positions reach the 300-key bucket
        assert keys.tables.n_pairs == 1 and want.sum() >= 64


@pytest.mark.parametrize("case", sorted(W2_SETS) + sorted(W2_MORE))
def test_literal_tables_invariants(case):
    """Each key of capped length >= 2 sits in exactly its first pair's
    bucket, which rank + offset find; the bitmap holds exactly those
    pairs and the rows of the first-byte table's bytes; the short keys'
    bytes are in the first-byte table; the ranks count the set bits
    before each word."""
    lits = {**W2_SETS, **W2_MORE}[case]
    keys = port_ls.LiteralKeys(lits)
    t = keys.tables
    bits, ranks, first, off, kv = blob_parts(t)
    present = np.unpackbits(bits.astype("<u4").view(np.uint8), bitorder="little").astype(bool)
    first_set = np.unpackbits(first.astype("<u4").view(np.uint8), bitorder="little").astype(bool)
    short = [i for i, n in enumerate(keys.lengths) if n <= 1]
    long_ = [i for i, n in enumerate(keys.lengths) if n >= 2]
    assert sorted(t.long_keys.tolist()) == long_ and off[0] == 0 and off[-1] == len(long_)
    assert np.array_equal(np.flatnonzero(first_set),
                          sorted({lits[i][:1][0] if lits[i] else 0 for i in short}))
    assert t.n_pairs == int(present.sum()) and np.all(np.diff(off) >= 0)
    popc = present.reshape(2048, 32).sum(axis=1)
    assert ranks[0] == 0 and np.array_equal(ranks[1:], np.cumsum(popc)[:-1])
    want = {(lits[i][0], lits[i][1]) for i in long_}
    want |= {(b, x) for b in np.flatnonzero(first_set).tolist() for x in range(256)}
    word, bit = port_ls.pair_slot([p[0] for p in want], [p[1] for p in want])
    slots = np.zeros(65536, bool)
    slots[word * 32 + bit] = True
    assert np.array_equal(slots, present)
    for i in long_:
        wd, bt = port_ls.pair_slot(lits[i][0], lits[i][1])
        rank = int(ranks[wd]) + int(present[wd * 32 : wd * 32 + bt].sum())
        bucket = t.long_keys[off[rank] : off[rank + 1]].tolist()
        assert bucket.count(i) == 1 and (t.long_keys == i).sum() == 1
        j = off[rank] + bucket.index(i)
        assert (kv[j, 0], kv[j, 1]) == (keys.mask[i], keys.value[i])
        assert all(lits[m][:2] == lits[i][:2] for m in bucket)
    assert (keys.form == "swar") == (len(lits) <= port_ls.SWAR_MAX)
    assert t.blob.size % 16 == 0 and t.off_at % 16 == 0 and t.keys_at % 16 == 0


def test_literal_block_counts_form_keyword():
    """form= forces either form; on a CPU tensor both give the plain
    counts, and a form that cannot take the keys raises."""
    lits = W2_SETS["K16"]
    keys = port_ls.LiteralKeys(lits)
    data = torch.from_numpy(w2_data(lits, 4096, 9))
    want = port_ls.literal_block_counts_torch(data, keys, 512)
    assert torch.equal(port_ls.literal_block_counts(data, keys, 512, form="table"), want)
    with pytest.raises(ValueError):
        port_ls.literal_block_counts(data, keys, 512, form="swar")  # 16 keys > SWAR_MAX
    with pytest.raises(ValueError):
        port_ls.literal_block_counts(data, keys, 512, form="linear")
    one = port_ls.LiteralKeys([b"fox"])
    assert one.form == "swar" and one.swar.shape == (144,)
    assert torch.equal(port_ls.literal_block_counts(data, one, 512, form="table"),
                       port_ls.literal_block_counts(data, one, 512, form="swar"))


def test_literal_keys_cover_max_length_one():
    """mask = max(L, 1) bytes; value = the literal's capped bytes."""
    mask, value = port_ls.literal_keys(*port_ls.literal_matrix(
        [b"", b"a", b"ab\x00", b"abcdefgh", b"abcdefghijk"]))
    assert mask.tolist() == [0xFF, 0xFF, 0xFFFFFF, 2**64 - 1, 2**64 - 1]
    assert value.tolist() == [0, 0x61, 0x6261, 0x6867666564636261, 0x6867666564636261]
    with pytest.raises(ValueError):
        port_ls.LiteralKeys([])


@pytest.mark.parametrize("case", sorted(W2_SETS))
def test_literal_block_counts_cpu_equals_reference_body(case):
    """literal_block_counts on a CPU tensor == the reference's per-shard
    body (literal_scan_bitmap, then bitmap_block_counts), and counts no
    kernel launch."""
    lits = W2_SETS[case]
    n = 8 << 10
    data = w2_data(lits, n, 3 + len(lits))
    mat, lens = ref_ls.literal_matrix(lits)
    want = np.asarray(ref_dfa.bitmap_block_counts(ref_ls.literal_scan_bitmap(
        jnp.asarray(mat), tuple(int(x) for x in lens), jnp.asarray(data)), 512))
    before = port_ls.literal_block_counts.launches
    got = port_ls.literal_block_counts(torch.from_numpy(data), port_ls.LiteralKeys(lits), 512)
    assert port_ls.literal_block_counts.launches == before
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        port_ls.literal_block_counts(torch.from_numpy(data[:-1]), port_ls.LiteralKeys(lits), 512)
