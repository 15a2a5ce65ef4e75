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
