"""The port's XOR-filter prefilter against the JAX package's.

The filter's construction (bank tables, multipliers, probes), the plain
PyTorch row bitmap, the lane-OR (packed, total) and the scanner's
decoded flags must equal the reference's exactly (tolerance: exact —
every output is integer bits). The reference runs its Pallas kernel in
interpret mode on the CPU and its numpy oracle. The CUDA kernel itself
runs only on the card: tests/test_torch_gpu.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grab_tpu.ops import pallas_bloom as ref_bloom
from grab_tpu.ops import pallas_corewords as ref_cw
from grab_tpu.ops import pallas_xorfilter as ref
from grab_tpu_torch.ops import xorfilter as port

LANES, PAD_ROWS, BLOCK = 128, 8, 512
N = 128 * 1024  # 256 word rows: 8 bitmap groups
SIZES = [1, 5, 25, 40, 80, 100, 250, 1000]  # remainder arities 1..4, up to 11 groups


def literals(k: int, seed: int, high: bool = False):
    rng = np.random.default_rng(seed)
    lo, hi = (0x80, 256) if high else (33, 127)
    return [bytes(rng.integers(lo, hi, size=int(rng.integers(7, 12)), dtype=np.uint8))
            for _ in range(k)]


def _words(kind: str, lits, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        buf = np.zeros(N, dtype=np.uint8)
    elif kind == "binary":
        buf = rng.integers(0, 256, size=N, dtype=np.uint8)
    else:
        buf = rng.integers(32, 127, size=N, dtype=np.uint8)
    spots = [0, 509, 32 * BLOCK - 3, 64 * BLOCK - 1, 100_001]
    spots += [1000 + 31 * i for i in range(20)]  # every phase
    spots += [r * BLOCK + 507 + d for r in (0, 77, 255) for d in range(4)]  # lane 127
    for i, pos in enumerate(spots):
        lit = lits[i % len(lits)]
        pos = min(pos, N - len(lit))
        buf[pos : pos + len(lit)] = np.frombuffer(lit, dtype=np.uint8)
    w = buf.view("<i4").reshape(-1, LANES)
    return np.concatenate([w, np.zeros((PAD_ROWS, LANES), "<i4")])


@pytest.fixture(scope="module")
def filters():
    """{k: (literals, reference tests, port tests)}, built once."""
    out = {}
    for k in SIZES:
        lits = literals(k, 31 + k)
        out[k] = (lits, ref.XorWordTests(lits), port.XorWordTests(lits))
    return out


@pytest.mark.parametrize("lit", [b"abcdefg", b"\x80\xff\x00\x01abcdefgh", b"0123456789ab"])
def test_phase_words_identical(lit):
    assert port._phase_words(lit) == ref_bloom._phase_words(lit)


@pytest.mark.parametrize("salt", [0, 1, 7, 255])
def test_hashes_identical(salt):
    assert port._salted_consts(salt) == ref._salted_consts(salt)
    c = port._salted_consts(salt)
    for x in (0, 1, 0x61626364, 0xFFFFFFFF, 0x80000000):
        assert port._hash_slots(x, c) == ref._hash_slots(x, c)


@pytest.mark.parametrize("k", SIZES)
def test_tables_identical(filters, k):
    _lits, r, p = filters[k]
    assert p.n_keys == r.n_keys
    assert p.consts() == r.consts()
    assert p.tables().dtype == r.tables().dtype == np.int32
    assert np.array_equal(p.tables(), r.tables())
    assert (p.probe_back, p.probe_fwd) == (r.probe_back, r.probe_fwd)
    assert port.group_bases(p.consts()) == ref.group_bases(r.consts())
    assert [len(c) for c in p.consts()][-1] == {
        1: 1, 5: 1, 25: 2, 40: 3, 80: 4, 100: 1, 250: 3, 1000: 3}[k]


def test_tables_identical_high_bytes():
    lits = literals(60, 9, high=True)
    r, p = ref.XorWordTests(lits), port.XorWordTests(lits)
    assert p.consts() == r.consts() and np.array_equal(p.tables(), r.tables())


@pytest.mark.parametrize("k", SIZES)
def test_program_layout(filters, k):
    """The kernel's input: header, arities, multipliers, bank rows."""
    _lits, _r, p = filters[k]
    prog = p.program().view(np.uint32)
    consts = p.consts()
    g, rows = len(consts), sum(len(c) for c in consts)
    assert tuple(prog[:2]) == (g, rows)
    assert tuple(prog[2 : 2 + g]) == tuple(len(c) for c in consts)
    assert tuple(prog[2 + g : 2 + g + rows]) == tuple(c for cs in consts for c in cs)
    assert np.array_equal(prog[2 + g + rows :].view(np.int32), p.tables().reshape(-1))


@pytest.mark.parametrize("k", SIZES)
def test_member_test_matches_oracle(filters, k):
    """The plain int32 arithmetic (wrapping multiply, masked shift) on
    the keys, on random words and on the words of bytes >= 0x80."""
    lits, r, p = filters[k]
    rng = np.random.default_rng(k)
    keys = np.array(sorted({w for l in lits for _j, w in port._phase_words(l)}), np.uint32)
    probe = np.concatenate([keys, rng.integers(0, 1 << 32, size=50_000, dtype=np.uint32),
                            np.zeros(4, np.uint32), np.array([0xFFFFFFFF, 0x80000000], np.uint32)])
    want = r.member_np(probe)
    assert want[: len(keys)].all()
    tbl = torch.from_numpy(p.tables())
    got = port.xor_member_torch(torch.from_numpy(probe.view(np.int32)), tbl, p.consts())
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(p.member_np(probe), want)


@pytest.mark.parametrize("kind", ["text", "binary", "zeros"])
@pytest.mark.parametrize("k", SIZES)
def test_plain_bitmap_matches_reference(filters, k, kind):
    lits, r, p = filters[k]
    w2d = _words(kind, lits, seed=k)
    bm_np = ref.np_xor_bitmap(w2d, r)
    total, packed, bm = port.xor_word_flags(torch.from_numpy(w2d), p)
    assert bm.dtype == torch.int32 and bm.shape == (N // BLOCK // 32, LANES)
    assert (bm.numpy() == bm_np).all()
    tot_ref, pk_ref = ref_cw.packed_block_flags(jnp.asarray(bm_np))
    assert (packed.numpy() == np.asarray(pk_ref)).all()
    assert int(total.item()) == int(tot_ref) > 0


@pytest.mark.parametrize("k", [5, 100])
def test_plain_bitmap_matches_reference_kernel(filters, k):
    """Against the Pallas kernel itself (interpret mode)."""
    lits, r, p = filters[k]
    w2d = _words("text", lits, seed=7)
    bm_pl = np.asarray(ref.xor_word_bitmap(
        jnp.asarray(w2d), jnp.asarray(r.tables()), r.consts(), tile_rows=64, interpret=True))
    _, _, bm = port.xor_word_flags(torch.from_numpy(w2d), p)
    assert (bm.numpy() == bm_pl).all()


@pytest.mark.parametrize("k", [5, 100])
def test_scanner_flags_match_reference_scanner(k):
    lits = literals(k, 3)
    w2d = _words("text", lits, seed=5)
    rsc = ref.XorWordScanner(lits, tile_rows=64, interpret=True)
    rtot, rpk = rsc.packed(jnp.asarray(w2d))
    psc = port.XorWordScanner(lits)
    ptot, ppk = psc.packed(torch.from_numpy(w2d))
    assert int(ptot.item()) == int(rtot) > 0
    nb = N // BLOCK
    assert (psc.flags_np(ppk.numpy(), nb) == rsc.flags_np(np.asarray(rpk), nb)).all()


def _kernel_model(w2d: np.ndarray, tests, copies: int) -> np.ndarray:
    """numpy model of what csrc/xorfilter.cu computes, in its form: the
    bank rows expanded into C interleaved copies (copy j of slot s at
    s*C + j; one compact copy for C = 1 and for the global form, 0),
    word 4l + k of a row read by lane l through copy l mod C, and the
    groups taken as the launch's remainder arity says (full 4-bank
    groups and one of arity rem, or each group's own arity when rem is
    0). → int32 [rows/32, 128] row bitmap."""
    prog = tests.program().view(np.uint32)
    n_groups, n_rows = int(prog[0]), int(prog[1])
    arity = prog[2 : 2 + n_groups]
    mult = prog[2 + n_groups : 2 + n_groups + n_rows].astype(np.uint64)
    c = max(copies, 1)
    expanded = np.repeat(prog[2 + n_groups + n_rows :].reshape(n_rows, LANES), c, axis=1)
    rem = port.remainder_arity(tests.consts())
    shape = [4] * (n_groups - 1) + [rem] if rem else [int(a) for a in arity]
    assert shape == [int(a) for a in arity]
    rows = w2d.shape[0] - PAD_ROWS
    x = w2d[:rows].view(np.uint32)
    copy = (np.arange(LANES) // 4) % c
    hit = np.zeros(x.shape, dtype=bool)
    base = 0
    for a in shape:
        acc = np.zeros(x.shape, dtype=np.uint32)
        for b in range(base, base + a):
            slot = ((x * mult[b]) & 0xFFFFFFFF) >> np.uint64(25)
            acc ^= expanded[b][(slot * c + copy).astype(np.int64)]
        hit |= acc == x
        base += a
    bits = hit.reshape(rows // 32, 32, LANES).astype(np.uint32) << np.arange(32, dtype=np.uint32)[:, None]
    return np.bitwise_or.reduce(bits, axis=1).view(np.int32)


def _any_shape(mod, lits):
    """``mod``'s filter of ``lits`` rebuilt as groups of arities 2, 4, 1,
    3: a shape the kernel does not unroll (the construction's split
    fallback can make one)."""
    tests = mod.XorWordTests(lits)
    keys = sorted({w for lit in lits for _j, w in port._phase_words(lit)})
    tests.groups = []
    for lo, hi, arity in ((0, 100, 2), (100, 484, 4), (484, 500, 1), (500, len(keys), 3)):
        tests._build_group(keys[lo:hi], arity)
    return tests


@pytest.mark.parametrize("copies", [32, 16, 1, 0])
@pytest.mark.parametrize("k", SIZES + ["any shape"])
def test_kernel_arithmetic_matches_reference(filters, k, copies):
    """The kernel's form, modelled in numpy, on every filter size
    (remainder arities 1-4) and on a shape of any arities, in every form
    the host can choose, equals the reference's numpy oracle."""
    if k == "any shape":
        lits = literals(200, 11)
        r, p = _any_shape(ref, lits), _any_shape(port, lits)
        assert p.consts() == r.consts() and port.remainder_arity(p.consts()) == 0
    else:
        lits, r, p = filters[k]
    for kind in ("text", "binary"):
        w2d = _words(kind, lits, seed=3)
        assert np.array_equal(_kernel_model(w2d, p, copies), ref.np_xor_bitmap(w2d, r))


@pytest.mark.parametrize("n_groups, n_rows, copies", [
    (1, 1, 32), (1, 3, 32), (2, 5, 32), (3, 11, 32), (4, 12, 32),  # 5-250 literals
    (4, 13, 16), (6, 22, 16), (7, 24, 16),  # 500 literals: 22 rows
    (7, 25, 1), (11, 43, 1), (100, 396, 1),  # 1000 literals: 43 rows
    (100, 397, 0), (105, 418, 0),  # 10,000 literals: 418 rows, 211 KiB
])
def test_bank_copies_choice(n_groups, n_rows, copies):
    """The most copies of 32, 16 and 1 whose shared memory (header and
    copied rows) fits SHARED_LIMIT, else global memory."""
    assert port.bank_copies(n_groups, n_rows) == copies
    head = (n_groups + n_rows + 3) // 4 * 16
    fits = [c for c in (32, 16, 1) if head + n_rows * 512 * c <= port.SHARED_LIMIT]
    assert copies == (fits[0] if fits else 0)


@pytest.mark.parametrize("arities, rem", [
    ([1], 1), ([4], 4), ([4, 4, 3], 3), ([4, 2], 2), ([2, 4], 0), ([4, 1, 4], 0),
])
def test_remainder_arity(arities, rem):
    consts = tuple((1,) * a for a in arities)
    assert port.remainder_arity(consts) == rem


def test_nul_word_not_member():
    """All-zero words (NUL runs) must not pass: unassigned slots are
    random-initialized, not zero."""
    p = port.XorWordTests(literals(20, 17))
    w = torch.zeros((32 + PAD_ROWS, LANES), dtype=torch.int32)
    total, packed, bm = port.xor_word_flags(w, p)
    assert int(total.item()) == 0 and not bm.any() and not packed.any()


def test_short_literal_rejected():
    with pytest.raises(AssertionError):
        port.XorWordTests([b"abcdef"])  # len 6 < 7


@pytest.mark.parametrize(
    "bad",
    [
        lambda w: w[:, :64],  # wrong lane count
        lambda w: w[: 40 + PAD_ROWS],  # rows not a multiple of 32
        lambda w: w.to(torch.int64),  # wrong dtype
        lambda w: w.reshape(-1),  # not 2-D
    ],
)
def test_wrapper_rejects_bad_input(bad):
    p = port.XorWordTests(literals(5, 1))
    w = torch.zeros((64 + PAD_ROWS, LANES), dtype=torch.int32)
    with pytest.raises(ValueError):
        port.xor_word_flags(bad(w), p)


def test_program_rejects_mismatched_table():
    p = port.XorWordTests(literals(5, 1))
    with pytest.raises(ValueError):
        port.xor_program(p.tables()[:0], p.consts())
    with pytest.raises(ValueError):
        port.xor_program(p.tables(), ())
