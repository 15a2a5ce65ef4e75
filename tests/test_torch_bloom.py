"""The port's bloom core-word prefilter against the JAX package's.

Tables and fields of BloomWordTests, the plain PyTorch bitmap, the
packed flags and the decoded flags must equal the reference's exactly
(tolerance: exact — every output is integer bits). The reference runs
its Pallas kernel in interpret mode on the CPU and its numpy oracle;
the five cases of tests/test_bloom.py are mirrored on the port. The
CUDA kernel itself runs only on the card: tests/test_torch_gpu.py and
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grab_tpu.golden.scanner import literal_scan_starts
from grab_tpu.ops import pallas_bloom as ref
from grab_tpu_torch.ops import bloom as port

BLOCK, LANES, PAD_ROWS = 512, 128, 8
TR = 64
N = 128 * 1024


def mk_words(data: bytes) -> np.ndarray:
    w = np.frombuffer(data, dtype="<i4").reshape(-1, LANES)
    return np.concatenate([w, np.zeros((PAD_ROWS, LANES), "<i4")])


def random_text(n, seed, needles=(), binary=False):
    rng = np.random.default_rng(seed)
    lo, hi = (0, 256) if binary else (32, 127)
    buf = bytearray(rng.integers(lo, hi, size=n, dtype=np.uint8).tobytes())
    for pos, s in needles:
        buf[pos : pos + len(s)] = s
    return bytes(buf)


def random_literals(k, seed, high=False):
    rng = np.random.default_rng(seed)
    lo, hi = (0x80, 256) if high else (33, 127)
    return [bytes(rng.integers(lo, hi, size=int(rng.integers(7, 13)), dtype=np.uint8))
            for _ in range(k)]


def test_constants_identical():
    assert port._HASH_CONSTS == ref._HASH_CONSTS
    assert (port.MAX_LEVELS, port.TBL_BITS) == (ref.MAX_LEVELS, ref.TBL_BITS)
    for w in (0, 1, 0x80000000, 0xFFFFFFFF, 0x6E696C75):
        for l in range(port.MAX_LEVELS):
            assert port._hashes(w, l) == ref._hashes(w, l)
    assert port._phase_words(b"needleXYZ") == ref._phase_words(b"needleXYZ")


@pytest.mark.parametrize("k,levels", [(1, 2), (5, 3), (16, 3), (100, 5), (400, 6), (1000, 6)])
def test_tables_identical(k, levels):
    lits = random_literals(k, 100 + k, high=(k == 16))
    a, b = ref.BloomWordTests(lits), port.BloomWordTests(lits)
    assert a.levels == b.levels == levels
    for f in ("n_keys", "probe_back", "probe_fwd", "literals"):
        assert getattr(a, f) == getattr(b, f), f
    assert b.tbl.dtype == np.int32 and b.tbl.shape == (levels, LANES)
    assert np.array_equal(a.tbl, b.tbl)


@pytest.mark.parametrize("kind", ["text", "binary"])
@pytest.mark.parametrize("k", [1, 10, 100, 1000])
def test_plain_bitmap_matches_reference_kernel_and_oracle(k, kind):
    """The plain version's row bitmap == the reference kernel in
    interpret mode == its numpy oracle; (total, packed) == the
    reference's packed_block_flags."""
    from grab_tpu.ops.pallas_corewords import packed_block_flags as ref_packed

    lits = random_literals(k, 21, high=(kind == "binary"))
    needles = [(1000 + 31 * i + i % 4, l) for i, l in enumerate(lits[:20])]
    needles.append((N - len(lits[0]), lits[0]))  # ends in the last word
    data = random_text(N, 7, needles, binary=(kind == "binary"))
    w2d = mk_words(data)
    a, b = ref.BloomWordTests(lits), port.BloomWordTests(lits)
    bm_np = ref.np_bloom_bitmap(w2d, a)
    bm_k = ref.bloom_word_bitmap(
        jnp.asarray(w2d), jnp.asarray(a.tbl), a.levels, tile_rows=TR, interpret=True
    )
    total, packed, bm = port.bloom_word_flags(torch.from_numpy(w2d), b)
    assert bm.dtype == torch.int32 and bm.shape == (N // 512 // 32, LANES)
    assert np.array_equal(bm.numpy(), bm_np) and np.array_equal(bm.numpy(), np.asarray(bm_k))
    t_ref, p_ref = ref_packed(bm_k)
    assert int(total) == int(t_ref) and np.array_equal(packed.numpy(), np.asarray(p_ref))
    assert int(total) > 0


def test_scanner_contract_identical():
    """BloomWordScanner: bitmap, packed and flags_np equal the
    reference scanner's on the same buffer."""
    lits = random_literals(100, 3)
    needles = [(997 + 517 * i + (i % 4), lits[i * 3 % 100]) for i in range(30)]
    w2d = mk_words(random_text(N, 5, needles))
    rs = ref.BloomWordScanner(lits, tile_rows=TR, interpret=True)
    ps = port.BloomWordScanner(lits)
    assert np.array_equal(ps.bitmap(torch.from_numpy(w2d)).numpy(),
                          np.asarray(rs.bitmap(jnp.asarray(w2d))))
    t_r, pk_r = rs.packed(jnp.asarray(w2d))
    t_p, pk_p = ps.packed(torch.from_numpy(w2d))
    assert int(t_p) == int(t_r) and np.array_equal(pk_p.numpy(), np.asarray(pk_r))
    nb = N // BLOCK
    assert np.array_equal(ps.flags_np(pk_p.numpy(), nb), rs.flags_np(np.asarray(pk_r), nb))


# -- the five cases of tests/test_bloom.py, on the port ----------------------


@pytest.mark.parametrize("k", [1, 10, 100])
def test_kernel_matches_numpy_oracle(k):
    lits = random_literals(k, 21)
    data = random_text(N, 7, [(1000 + 31 * i, l) for i, l in enumerate(lits[:20])])
    w2d = mk_words(data)
    t = port.BloomWordTests(lits)
    bm = port.bloom_bitmap_torch(torch.from_numpy(w2d), t.tbl, t.levels)
    assert (bm.numpy() == ref.np_bloom_bitmap(w2d, t)).all()


def test_superset_100_literals():
    lits = random_literals(100, 3)
    needles = [(997 + 517 * i + (i % 4), lits[i * 3 % 100]) for i in range(30)]
    data = random_text(N, 5, needles)
    sc = port.BloomWordScanner(lits)
    total, packed = sc.packed(torch.from_numpy(mk_words(data)))
    flags = sc.flags_np(packed.numpy(), N // BLOCK)
    starts = literal_scan_starts(lits, data)
    want = np.unique(np.nonzero(starts)[0] // BLOCK)
    assert len(want) >= 25
    missed = [b for b in want if not flags[b]]
    assert not missed, missed


def test_false_positive_budget():
    lits = random_literals(100, 9)
    data = random_text(N, 11)  # nothing planted
    sc = port.BloomWordScanner(lits)
    total, packed = sc.packed(torch.from_numpy(mk_words(data)))
    flags = sc.flags_np(packed.numpy(), N // BLOCK)
    assert flags.mean() < 0.05, flags.mean()


def test_levels_scale_with_k():
    small = port.BloomWordTests(random_literals(4, 1)).levels
    large = port.BloomWordTests(random_literals(100, 1)).levels
    assert small < large <= 6


def test_short_literal_rejected():
    with pytest.raises(AssertionError):
        port.BloomWordTests([b"abcdef"])  # len 6 < 7


@pytest.mark.parametrize(
    "bad",
    [
        lambda w: w[:, :64],  # wrong lane count
        lambda w: w[:50],  # rows not 32*g + 8
        lambda w: w.to(torch.int64),  # wrong dtype
    ],
)
def test_wrapper_rejects_bad_geometry(bad):
    t = port.BloomWordTests([b"needleXY"])
    w = torch.zeros((64 + PAD_ROWS, LANES), dtype=torch.int32)
    with pytest.raises(ValueError):
        port.bloom_word_flags(bad(w), t)
