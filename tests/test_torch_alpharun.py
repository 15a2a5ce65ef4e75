"""The port's alphabet-run prefilter against the JAX package's.

The planner, the plain PyTorch row bitmap (coarse and fine), the lane-OR
(packed, total), the scanner's decoded flags and the alpha routing of
DeviceScanner must equal the reference's exactly (tolerance: exact —
every output is integer bits). The reference runs its Pallas kernel in
interpret mode on the CPU and its numpy oracle. The CUDA kernel itself
runs only on the card: tests/test_torch_gpu.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grab_tpu.ops import pallas_alpharun as ref
from grab_tpu.ops import pallas_corewords as ref_cw
from grab_tpu.regex.compiler import compile_multi as ref_compile
from grab_tpu_torch.ops import alpharun as port
from grab_tpu_torch.regex.compiler import compile_multi

LANES, PAD_ROWS, BLOCK = 128, 8, 512
ROWS = 128  # 64 KiB: 4 bitmap groups
N = ROWS * BLOCK

DIGITS = ((48, 57),)
HEX = ((48, 57), (65, 70), (97, 102))
WITH_NUL = ((0, 0), (48, 57))  # the zero pad rows are members
HIGH = ((0x80, 0xBF), (0xF0, 0xFF))
EIGHT = tuple((16 * i + 1, 16 * i + 6) for i in range(8))
RANGE_SETS = {"digits": DIGITS, "hex": HEX, "nul": WITH_NUL, "high": HIGH, "eight": EIGHT}
MIN_LENS = [1, 2, 3, 5, 7, 12, 20, 40]  # fine 1, 2, 2, 4; coarse 1, 2, 4, 8


def _member_bytes(ranges, rng, n):
    pool = np.concatenate([np.arange(lo, hi + 1) for lo, hi in ranges]).astype(np.uint8)
    return rng.choice(pool, size=n)


def _buffer(kind: str, ranges, seed: int) -> np.ndarray:
    """Words [ROWS + 8, 128] with runs of member bytes of assorted
    lengths across row, 32-row group and buffer-end boundaries."""
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        buf = np.zeros(N, dtype=np.uint8)
    elif kind == "binary":
        buf = rng.integers(0, 256, size=N, dtype=np.uint8)
    else:
        buf = rng.integers(58, 65, size=N, dtype=np.uint8)  # ":;<=>?@": no member
    plants = [(3, 60), (517, 12), (1025, 7), (2048, 5), (4999, 3), (6000, 2), (9003, 1),
              (12345, 41), (BLOCK - 9, 40), (32 * BLOCK - 17, 36), (64 * BLOCK - 2, 9),
              (N - 33, 33), (N - 3, 3), (40_001, 4), (40_010, 4)]
    for pos, ln in plants:
        buf[pos : pos + ln] = _member_bytes(ranges, rng, ln)
    w = buf.view("<i4").reshape(ROWS, LANES)
    return np.concatenate([w, np.zeros((PAD_ROWS, LANES), "<i4")])


@pytest.mark.parametrize("min_len", list(range(0, 45)))
def test_planner_identical(min_len):
    assert port.plan_for(min_len) == ref.plan_for(min_len)
    for ranges in list(RANGE_SETS.values()) + [((97, 122),), None, ()]:
        assert port.alpharun_eligible(ranges, min_len) == ref.alpharun_eligible(ranges, min_len)
        if ranges:
            assert port.flag_density(ranges, min_len) == ref.flag_density(ranges, min_len)


def test_ranges_of_identical():
    rng = np.random.default_rng(3)
    for _ in range(20):
        alpha = rng.random(256) < 0.4
        assert port.ranges_of(alpha) == ref.ranges_of(alpha)
    full = np.ones(256, bool)
    assert port.ranges_of(full) == ref.ranges_of(full) == ((0, 255),)


@pytest.mark.parametrize("kind", ["text", "binary", "zeros"])
@pytest.mark.parametrize("min_len", MIN_LENS)
@pytest.mark.parametrize("name", list(RANGE_SETS))
def test_plain_bitmap_matches_reference(name, min_len, kind):
    ranges = RANGE_SETS[name]
    mode, units = ref.plan_for(min_len)
    w2d = _buffer(kind, ranges, seed=min_len)
    bm_np = ref.np_alpharun_bitmap(w2d, ranges, min_len)
    total, packed, bm = port.alpharun_flags(torch.from_numpy(w2d), ranges, mode, units)
    assert bm.dtype == torch.int32 and bm.shape == (ROWS // 32, LANES)
    assert (bm.numpy() == bm_np).all()
    tot_ref, pk_ref = ref_cw.packed_block_flags(jnp.asarray(bm_np))
    assert (packed.numpy() == np.asarray(pk_ref)).all()
    assert int(total.item()) == int(tot_ref)
    if kind == "text" or name == "nul":
        assert int(total.item()) > 0


@pytest.mark.parametrize("min_len", MIN_LENS)
@pytest.mark.parametrize("name", ["digits", "nul", "eight"])
def test_plain_bitmap_matches_reference_kernel(name, min_len):
    """Against the Pallas kernel itself (interpret mode)."""
    ranges = RANGE_SETS[name]
    mode, units = ref.plan_for(min_len)
    w2d = _buffer("text", ranges, seed=100 + min_len)
    bm_pl = np.asarray(ref.alpharun_word_bitmap(
        jnp.asarray(w2d), ranges, mode, units, tile_rows=32, interpret=True))
    _, _, bm = port.alpharun_flags(torch.from_numpy(w2d), ranges, mode, units)
    assert (bm.numpy() == bm_pl).all()


@pytest.mark.parametrize("min_len", [2, 4, 11, 40])
def test_scanner_flags_match_reference_scanner(min_len):
    w2d = _buffer("text", HEX, seed=5)
    rsc = ref.AlphaRunScanner(HEX, min_len, tile_rows=32, interpret=True)
    rtot, rpk = rsc.packed(jnp.asarray(w2d))
    psc = port.AlphaRunScanner(HEX, min_len)
    assert (psc.ranges, psc.mode, psc.units) == (rsc.ranges, rsc.mode, rsc.units)
    assert (psc.probe_back, psc.probe_fwd) == (rsc.probe_back, rsc.probe_fwd)
    ptot, ppk = psc.packed(torch.from_numpy(w2d))
    assert int(ptot.item()) == int(rtot) > 0
    nb = N // BLOCK
    assert (psc.flags_np(ppk.numpy(), nb) == rsc.flags_np(np.asarray(rpk), nb)).all()


@pytest.mark.parametrize(
    "bad",
    [
        lambda w: (w[:, :64], DIGITS, "coarse", 2),  # wrong lane count
        lambda w: (w[: 40 + PAD_ROWS], DIGITS, "coarse", 2),  # rows not 32*g
        lambda w: (w.to(torch.int64), DIGITS, "coarse", 2),  # wrong dtype
        lambda w: (w, DIGITS, "coarse", 3),  # units not a power of two
        lambda w: (w, DIGITS, "fine", 8),  # fine runs stop at 4 bytes
        lambda w: (w, DIGITS * 9, "fine", 2),  # more than 8 ranges
        lambda w: (w, (), "fine", 2),  # no range
        lambda w: (w, ((5, 300),), "fine", 2),  # not a byte
    ],
)
def test_wrapper_rejects_bad_input(bad):
    w = torch.from_numpy(_buffer("zeros", DIGITS, 0))
    with pytest.raises(ValueError):
        port.alpharun_flags(*bad(w))


# -- DeviceScanner, alpha mode ----------------------------------------------

ALPHA_ROUTES = [
    (rb".{0,2}[0-9]{11}", "coarse"),  # uncovered, with an automaton
    (rb".{0,2}([0-9a-f]{12})\1", "coarse"),  # backreference: no automaton at all
    (rb".{0,2}[0-9\x80-\x8f]{9}", "coarse"),  # one word, bytes >= 0x80
    (rb".{0,2}([0-9]{6})\1", "fine"),  # a run under 7 bytes: fine mode, no automaton
]


@pytest.mark.parametrize("pattern,mode", ALPHA_ROUTES, ids=[p.decode("latin-1") for p, _ in ALPHA_ROUTES])
@pytest.mark.parametrize("buf_size", [64 << 10, 1 << 20])
def test_alpha_flags_match_reference(pattern, mode, buf_size):
    """One packer buffer with planted runs: the port's scan == the
    reference DeviceScanner's (Pallas interpret mode), same mode, member
    type and plan."""
    from grab_tpu.scan_pipeline import DeviceScanner as RefScanner
    from grab_tpu_torch.scan_pipeline import DeviceScanner

    rcp, pcp = ref_compile([pattern]), compile_multi([pattern])
    assert pcp.alpha_plan == rcp.alpha_plan and pcp.alpha_plan is not None
    r = RefScanner(rcp, buf_size=buf_size, pallas_interpret=True)
    p = DeviceScanner(pcp, buf_size=buf_size, devices=["cpu"])
    assert r.mode == p.mode == "alpha"
    rm, pm = r._cw_list[0], p.members[0]
    assert type(pm).__name__ == type(rm).__name__ == "AlphaRunScanner"
    assert (pm.ranges, pm.mode, pm.units) == (rm.ranges, rm.mode, rm.units)
    assert pm.mode == mode
    rng = np.random.default_rng(31)
    buf = rng.integers(58, 127, size=buf_size + 32 * 512, dtype=np.uint8)
    buf[buf_size:] = 0
    for pos in (1000, buf_size // 2 - 3, buf_size - 11, 32 * 1024 - 5):
        buf[pos : pos + 11] = np.frombuffer(b"91827364550", np.uint8)
        buf[pos + 40 : pos + 64] = np.frombuffer(b"0123456789ab0123456789ab", np.uint8)
        buf[pos + 100 : pos + 110] = 0x85
        buf[pos + 130 : pos + 142] = np.frombuffer(b"123456123456", np.uint8)
    want = r.scan(buf)
    got = p.scan(buf)
    assert got.dtype == want.dtype and np.array_equal(got, want) and got.sum() > 0
    clean = rng.integers(103, 123, size=buf_size, dtype=np.uint8)  # g-z only
    assert p.scan(clean).sum() == r.scan(clean).sum() == 0


# the kernel's plans and a min_len the reference planner maps to each
PLAN_MIN_LEN = {("coarse", 1): 7, ("coarse", 2): 11, ("coarse", 4): 19, ("coarse", 8): 35,
                ("fine", 1): 1, ("fine", 2): 2, ("fine", 4): 4}


def _ranges_of_count(n: int):
    """n disjoint ranges; an even count holds byte 0 (the pad rows are
    members), counts over 4 hold bytes >= 0x80."""
    out = [(30 * i + 20, 30 * i + 24 + i) for i in range(n)]
    if n % 2 == 0:
        out[0] = (0, 0)
    return tuple(out)


@pytest.mark.parametrize("plan", list(PLAN_MIN_LEN), ids=lambda p: f"{p[0]}{p[1]}")
@pytest.mark.parametrize("n_ranges", range(1, 9))
def test_kernel_arithmetic_matches_reference(n_ranges, plan):
    """csrc/alpharun.cu's arithmetic (one code per lane of 4 words, the
    neighbour codes as the warp's shuffles take them, lanes 30 and 31
    from the next row), written out in PyTorch, against the reference's
    numpy oracle on text and binary buffers with runs across row, group
    and buffer-end boundaries: the codes and their shuffles are held
    here, the kernel itself on the card."""
    ranges = _ranges_of_count(n_ranges)
    mode, units = plan
    assert ref.plan_for(PLAN_MIN_LEN[plan]) == plan
    hits = 0
    for kind in ("text", "binary"):
        w2d = _buffer(kind, ranges, seed=10 * n_ranges + units)
        bm = port.alpharun_bitmap_swar(torch.from_numpy(w2d), ranges, mode, units)
        assert (bm.numpy() == ref.np_alpharun_bitmap(w2d, ranges, PLAN_MIN_LEN[plan])).all()
        hits += int((bm != 0).sum())
    assert hits > 0
