"""The port's class-sequence prefilter against the JAX package's.

The compiled sequences, the plain PyTorch row bitmap, the lane-OR
(packed, total), the scanner's decoded flags and the class_seq routing
of DeviceScanner must equal the reference's exactly (tolerance: exact —
every output is integer bits). The reference runs its Pallas kernel in
interpret mode on the CPU and its numpy oracle. The CUDA kernel itself
runs only on the card: tests/test_torch_gpu.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grab_tpu.ops import class_prefilter as ref_cp
from grab_tpu.ops import pallas_classseq as ref
from grab_tpu.ops import pallas_corewords as ref_cw
from grab_tpu.regex.compiler import compile_multi as ref_compile
from grab_tpu_torch.ops import classseq as port
from grab_tpu_torch.regex.compiler import compile_multi

LANES, PAD_ROWS, BLOCK = 128, 8, 512
N = 64 * 1024  # 128 word rows: 4 bitmap groups

DIGIT = sum(1 << b for b in range(48, 58))
DASH = 1 << ord("-")
AB = (1 << ord("a")) | (1 << ord("b"))
HIGH = sum(1 << b for b in range(0x80, 0xC0)) | (1 << 0xFF)
TAB = 1 << 9


def _mask_sets():
    """Sequence sets of 1, 8 and 32 sequences, classes with bytes
    >= 0x80 and up to 8 ranges."""
    rng = np.random.default_rng(32)
    many = []
    for i in range(32):
        n = 1 + i % 8
        seq = []
        for j in range(n):
            lo = int(rng.integers(0, 250))
            m = sum(1 << b for b in range(lo, lo + 1 + int(rng.integers(0, 6))))
            if (i + j) % 5 == 0:
                m |= HIGH
            seq.append(m)
        many.append(tuple(seq))
    eight = [tuple([DIGIT] * (1 + i)) for i in range(7)] + [(AB, DASH, HIGH)]
    frag = sum(1 << b for b in range(ord("a"), ord("z") + 1, 2))  # 13 ranges → capped
    return [
        [(DIGIT, DIGIT, DIGIT, DASH, DIGIT)],
        [(AB, AB)],
        [(DIGIT,) * 8, (AB, DASH)],
        [(TAB, DIGIT, DIGIT | TAB)],
        [(HIGH, HIGH, AB)],
        [(frag, frag, frag)],
        eight,
        many,
    ]


MASK_SETS = _mask_sets()
IDS = [f"set{i}-{len(s)}seq" for i, s in enumerate(MASK_SETS)]


def _words(data: bytes) -> np.ndarray:
    w = np.frombuffer(data, dtype="<i4").reshape(-1, LANES)
    return np.concatenate([w, np.zeros((PAD_ROWS, LANES), "<i4")])


def _needle(seq, rng) -> bytes:
    """One byte string matching the mask sequence."""
    out = []
    for m in seq:
        members = [b for b in range(256) if (m >> b) & 1]
        out.append(members[int(rng.integers(0, len(members)))])
    return bytes(out)


def _buffer(kind: str, mask_set, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        buf = np.zeros(N, dtype=np.uint8)
    elif kind == "binary":
        buf = rng.integers(0, 256, size=N, dtype=np.uint8)
    else:
        buf = rng.integers(64, 91, size=N, dtype=np.uint8)  # uppercase text
    spots = [0, 509, 32 * BLOCK - 3, 64 * BLOCK - 1, 40_001, 40_002]
    spots += [r * BLOCK + 507 + d for r in (0, 77) for d in range(4)]  # lane 127
    for i, pos in enumerate(spots):
        s = _needle(mask_set[i % len(mask_set)], rng)
        buf[pos : pos + len(s)] = np.frombuffer(s, dtype=np.uint8)
    last = _needle(mask_set[-1][:3], rng)  # starts in the last word
    buf[N - len(last) :] = np.frombuffer(last, dtype=np.uint8)
    return _words(buf.tobytes())


@pytest.mark.parametrize("mask_set", MASK_SETS, ids=IDS)
def test_compile_sequences_identical(mask_set):
    assert port.compile_sequences(mask_set) == ref_cp.compile_sequences(mask_set)


@pytest.mark.parametrize(
    "pattern", [rb"[0-9]{5}", rb"\t[0-9]+\t", rb"[A-Z]{6}[0-9]{6}", rb"n[a-z]+e",
                rb"[0-9]{4}-[0-9]{2}-[0-9]{2}", rb"[\x80-\xff][a-c]{2}"]
)
def test_compiled_pattern_sequences_identical(pattern):
    r, p = ref_compile([pattern]), compile_multi([pattern])
    assert p.class_seqs == r.class_seqs
    assert port.compile_sequences(p.class_seqs) == ref_cp.compile_sequences(r.class_seqs)


@pytest.mark.parametrize("kind", ["text", "binary", "zeros"])
@pytest.mark.parametrize("mask_set", MASK_SETS, ids=IDS)
def test_plain_bitmap_matches_reference(mask_set, kind):
    seqs = ref_cp.compile_sequences(mask_set)
    w2d = _buffer(kind, mask_set, seed=len(mask_set))
    bm_np = ref.np_classseq_bitmap(w2d, seqs)
    bm_pl = np.asarray(ref.classseq_word_bitmap(jnp.asarray(w2d), seqs, tile_rows=64,
                                                interpret=True))
    total, packed, bm = port.classseq_flags(torch.from_numpy(w2d), seqs)
    assert bm.dtype == torch.int32 and bm.shape == (N // BLOCK // 32, LANES)
    assert (bm.numpy() == bm_np).all() and (bm.numpy() == bm_pl).all()
    tot_ref, pk_ref = ref_cw.packed_block_flags(jnp.asarray(bm_np))
    assert (packed.numpy() == np.asarray(pk_ref)).all()
    assert int(total.item()) == int(tot_ref) > 0


@pytest.mark.parametrize("mask_set", MASK_SETS, ids=IDS)
def test_scanner_flags_match_reference_scanner(mask_set):
    seqs = ref_cp.compile_sequences(mask_set)
    w2d = _buffer("text", mask_set, seed=3)
    rsc = ref.ClassSeqScanner(seqs, tile_rows=64, interpret=True)
    rtot, rpk = rsc.packed(jnp.asarray(w2d))
    psc = port.ClassSeqScanner(seqs)
    assert (psc.probe_back, psc.probe_fwd) == (rsc.probe_back, rsc.probe_fwd)
    ptot, ppk = psc.packed(torch.from_numpy(w2d))
    assert int(ptot.item()) == int(rtot)
    nb = N // BLOCK
    assert (psc.flags_np(ppk.numpy(), nb) == rsc.flags_np(np.asarray(rpk), nb)).all()


def test_descriptor_layout():
    seqs = port.compile_sequences(MASK_SETS[2])  # [(DIGIT,)*8, (AB, DASH)]
    d = port.seq_descriptor(seqs)
    assert d.dtype == np.uint8 and d.size == 8 + 32 + 256 + 2048 + 2048
    assert tuple(d[:8].view("<i4")) == (2, 8)
    lens, n_rng = d[8:40], d[40:296].reshape(32, 8)
    lo = d[296:2344].reshape(32, 8, 8)
    hi = d[2344:].reshape(32, 8, 8)
    assert tuple(lens[:3]) == (8, 2, 0)
    assert tuple(n_rng[1, :3]) == (1, 1, 0)
    assert (lo[0, :, 0] == 48).all() and (hi[0, :, 0] == 57).all()
    assert (lo[1, 0, 0], hi[1, 0, 0], lo[1, 1, 0], hi[1, 1, 0]) == (97, 98, 45, 45)
    assert [port.swar_bound(b) for b in (0, 128, 129, 256)] == [
        (0x80808080, 0xFFFFFFFF), (0, 0xFFFFFFFF), (127 * 0x01010101, 0), (0, 0)]


@pytest.mark.parametrize("kind", ["text", "binary", "zeros"])
@pytest.mark.parametrize("mask_set", MASK_SETS, ids=IDS)
def test_kernel_arithmetic_matches_reference(mask_set, kind):
    """The CUDA kernel's arithmetic (up to 8 sequences: 4 phases per
    word, the descriptor's SWAR compare constants; more: the sequence-bit
    tables), written out in PyTorch, against the reference's numpy
    oracle: the descriptors and the compares are held here, the kernel
    itself on the card."""
    seqs = ref_cp.compile_sequences(mask_set)
    w2d = _buffer(kind, mask_set, seed=7 + len(mask_set))
    bm = port.classseq_bitmap_kernel(torch.from_numpy(w2d), seqs)
    assert (bm.numpy() == ref.np_classseq_bitmap(w2d, seqs)).all()


def test_swar_compare_every_byte_and_bound():
    """ge(b) of the kernel for every byte value and bound 0..256."""
    x = torch.arange(256, dtype=torch.int64)
    for b in range(257):
        add, keep = port.swar_bound(b)
        t = ((x & 0x7F) + (add & 0xFF)) & 0xFF
        ge = ((t & (x | (keep & 0xFF))) | (x & (keep & 0xFF))) & 0x80
        assert torch.equal(ge != 0, x >= b), b


@pytest.mark.parametrize(
    "bad",
    [
        lambda w, s: (w[:, :64], s),  # wrong lane count
        lambda w, s: (w[: 40 + PAD_ROWS], s),  # rows not a multiple of 32
        lambda w, s: (w.to(torch.int64), s),  # wrong dtype
        lambda w, s: (w, s * 33),  # more than 32 sequences
        lambda w, s: (w, ()),  # no sequence
    ],
)
def test_wrapper_rejects_bad_input(bad):
    seqs = port.compile_sequences(MASK_SETS[1])
    w = torch.from_numpy(_buffer("zeros", MASK_SETS[1], 0))
    w2, s2 = bad(w, seqs)
    with pytest.raises(ValueError):
        port.classseq_flags(w2, s2)


# -- DeviceScanner, class_seq mode ------------------------------------------

SEQ_ROUTES = [
    ([rb"[0-9]{4}-[0-9]{2}-[0-9]{2}"], False, 2 << 20),
    ([rb"[A-Z]{6}[0-9]{6}"], False, 2 << 20),
    ([rb"\t[0-9]+\t"], False, 2 << 20),
    ([rb"[0-9]{5}"], False, 256 << 10),  # under 1 MiB: the word kernel
    ([b"ab"], True, 2 << 20),  # a 2-byte literal (-S) is a class sequence
    ([b"ab"], True, 256 << 10),
]


@pytest.mark.parametrize("pats,literal,buf_size", SEQ_ROUTES,
                         ids=[f"{p[0].decode()}-{b}" for p, _, b in SEQ_ROUTES])
def test_class_seq_flags_match_reference(pats, literal, buf_size):
    """One packer buffer with planted hits: the port's resolve == the
    reference DeviceScanner's (Pallas interpret mode), same mode and
    member type."""
    from grab_tpu.scan_pipeline import DeviceScanner as RefScanner
    from grab_tpu_torch.scan_pipeline import DeviceScanner

    r = RefScanner(ref_compile(pats, literal_mode=literal), buf_size=buf_size,
                   pallas_interpret=True)
    p = DeviceScanner(compile_multi(pats, literal_mode=literal), buf_size=buf_size,
                      devices=["cpu"])
    assert r.mode == p.mode == "class_seq"
    assert type(p.members[0]).__name__ == type(r._cw_list[0]).__name__
    rng = np.random.default_rng(8)
    buf = rng.integers(65, 91, size=buf_size + 32 * 512, dtype=np.uint8)
    buf[buf_size:] = 0
    plants = [b"2026-08-21", b"QWERTY123456", b"\t123\t", b"55512", b"ab"]
    for pos in (7777, buf_size // 2 + 1, buf_size - 11, 64 * 1024 - 3):
        for k, s in enumerate(plants):
            at = min(pos + 40 * k, buf_size - len(s))
            buf[at : at + len(s)] = np.frombuffer(s, np.uint8)
    want = r.scan(buf)
    got = p.scan(buf)
    assert got.dtype == want.dtype and np.array_equal(got, want) and got.sum() > 0


def test_seq_params_constants_match_bound():
    """The host-made SWAR constants of B4's descriptor (swar_bounds, one
    call for all bounds) against Bound's formula (swar_bound) for every
    bound 0..256, and what they compute against "byte >= b" for every
    byte value."""
    b = np.arange(257)
    add, keep = port.swar_bounds(b)
    assert add.dtype == np.uint32
    for i in range(257):
        assert (int(add[i]), 0xFFFFFFFF if keep[i] else 0) == port.swar_bound(i)
    x = np.arange(256, dtype=np.int64)[None, :]
    t = ((x & 0x7F) + (add.astype(np.int64)[:, None] & 0xFF)) & 0xFF
    k = np.where(keep, 0xFF, 0)[:, None]
    ge = (((t & (x | k)) | (x & k)) & 0x80) != 0
    assert (ge == (x >= b[:, None])).all()


def _params_sequences(params: np.ndarray):
    """The sequences back from seq_params' bytes (each bound from its
    add word and keep flag: b = 128 - add for keep, else 256 - add)."""
    f = port.params_fields(params)
    out = []
    for s in range(int(f["head"][0])):
        seq = []
        for j in range(int(f["len"][s])):
            ranges = []
            for t in range(int(f["n_ranges"][s, j])):
                b = []
                for e in range(2):
                    a = int(f["add"][s, j, t, e]) & 0xFF
                    b.append(128 - a if (int(f["keep"][s, j]) >> (2 * t + e)) & 1 else 256 - a)
                ranges.append((b[0], b[1] - 1))
            seq.append(tuple(ranges))
        out.append(tuple(seq))
    return tuple(out)


@pytest.mark.parametrize("mask_set", MASK_SETS, ids=IDS)
def test_seq_params_round_trip(mask_set):
    """B4's SWAR descriptor holds the sequences: its size is
    SeqParams<cap>'s for the least cap of 1 and 8 (larger sets take the
    table form), and the bounds read back from its add words and keep
    bits are the ranges; the fused kernel's SeqDesc bytes still
    round-trip too."""
    seqs = port.compile_sequences(mask_set)
    if len(seqs) > 8:  # the table form's sets
        with pytest.raises(ValueError):
            port.seq_params(seqs)
        assert port.kernel_descriptor(seqs) is port.seq_tables(seqs)
    else:
        p = port.seq_params(seqs)
        assert p.dtype == np.uint8 and p.size == (548 if len(seqs) == 1 else 4304)
        assert _params_sequences(p) == seqs
        f = port.params_fields(p)
        assert tuple(f["head"]) == (len(seqs), port.seq_span(seqs))
        assert port.kernel_descriptor(seqs) is p
    d = port.seq_descriptor(seqs)
    n, span = d[:8].view("<i4")
    lens, n_rng = d[8:40], d[40:296].reshape(32, 8)
    lo, hi = d[296:2344].reshape(32, 8, 8), d[2344:].reshape(32, 8, 8)
    back = tuple(tuple(tuple((int(lo[s, j, t]), int(hi[s, j, t])) for t in range(n_rng[s, j]))
                       for j in range(lens[s])) for s in range(n))
    assert back == seqs and span == port.seq_span(seqs)


@pytest.mark.parametrize("kind", ["text", "binary", "zeros"])
@pytest.mark.parametrize("mask_set", MASK_SETS, ids=IDS)
def test_table_arithmetic_matches_reference(mask_set, kind):
    """The table kernel's arithmetic (csrc/classseq.cu SeqTables: one
    sequence bit per table entry, AND over the classes), written out in
    PyTorch over seq_tables' bytes, against the reference's numpy
    oracle; and the tables' bits hold exactly the classes."""
    seqs = ref_cp.compile_sequences(mask_set)
    w2d = _buffer(kind, mask_set, seed=11 + len(mask_set))
    bm = port.classseq_bitmap_tables(torch.from_numpy(w2d), seqs)
    assert (bm.numpy() == ref.np_classseq_bitmap(w2d, seqs)).all()
    raw = port.seq_tables(seqs)
    assert raw.size == 8 + 8 * 256 * 4
    assert tuple(raw[:8].view("<i4")) == (port.seq_span(seqs), len(seqs))
    t = raw[8:].view("<u4").reshape(8, 256)
    for s, seq in enumerate(seqs):  # classes as compiled (capped at 8 ranges)
        for j in range(8):
            got = sum(1 << b for b in range(256) if (int(t[j, b]) >> s) & 1)
            want = (sum(1 << b for lo, hi in seq[j] for b in range(lo, hi + 1))
                    if j < len(seq) else (1 << 256) - 1)
            assert got == want, (s, j)
    assert not (t[0] >> len(seqs)).any()  # no bit past the last sequence
