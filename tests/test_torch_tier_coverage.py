"""The port's device-tier choice against the JAX package's, over the
reference's tier-coverage battery (``tools/tier_coverage.py``, loaded from
its file, unchanged).

For each of the battery's patterns at the reference's 32 MiB buffer, the
port's ``DeviceScanner(devices=["cpu"])`` must land on the tier the
reference's ``classify`` reports (the same (mode, detail) strings, built
from the port's scanner), with the same member types and, for every
strided-DFA member, the same plan (mode, k, states, window mode) as the
reference's ``DeviceScanner`` in interpret mode; and ``-E`` must be served
as the reference's ``exact_tier`` says. Tolerance: exact.
"""

import importlib.util
import os

import pytest

from grab_tpu.regex.compiler import compile_multi as ref_compile
from grab_tpu.scan_pipeline import DeviceScanner as RefScanner
from grab_tpu_torch.ops.stridedfa import stride_plan
from grab_tpu_torch.regex.compiler import compile_multi
from grab_tpu_torch.scan_pipeline import DeviceScanner
from tests._torch_threads import _one_thread  # noqa: F401 (autouse: one intra-op thread)

_spec = importlib.util.spec_from_file_location(
    "grab_tpu_tools_tier_coverage",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "tools", "tier_coverage.py"),
)
_tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_tool)

BUF = 32 << 20


def port_classify(pat: bytes):
    """``tools/tier_coverage.py`` ``classify`` over the port's scanner:
    → ((mode, detail), scanner or None)."""
    cp = compile_multi([pat])
    try:
        sc = DeviceScanner(cp, buf_size=BUF, devices=["cpu"])
    except ValueError:
        return ("host-only", "no device-scannable form"), None
    mode, d = sc.mode, ""
    if mode == "literal":
        d = f"{len(cp.literals)} literal(s)" + (" + class-seq" if cp.class_seqs else "")
    elif mode == "class_seq":
        d = f"{len(cp.class_seqs)} seq(s)"
    elif mode == "alpha":
        ranges, runlen = cp.alpha_plan
        d = f"ranges={ranges} run>={runlen}"
    elif mode == "gdfa":
        g, t = sc._gdfa, sc._gdfa.tables
        mode = "stride-dfa"
        d = (f"plan=({t.mode},{t.k}) states={t.n_states} m={t.m} "
             f"{'window' if g.window_mode else 'threaded'}")
    elif mode == "dfa":
        d = f"jnp walk: states={cp.dfa.n_states}"
    return (mode, d), sc


def port_exact_tier(pat: bytes) -> str:
    """``tools/tier_coverage.py`` ``exact_tier`` over the port's compiler
    and stride planner."""
    cp = compile_multi([pat])
    plan = stride_plan(cp.dfa) if cp.dfa is not None else None
    stride = f"stride({plan[0]},k={plan[1]}) states={cp.dfa.n_states}" if plan else None
    if cp.covered:
        return "device prefilter+replay" + (f" [{stride} avail]" if stride else "")
    if stride:
        return stride
    if cp.dfa is None:
        return "host (not DFA-able)"
    return f"host (states={cp.dfa.n_states} over capacity)"


def members(sc):
    """[(type name, stride plan or None)] of a scanner's members: the
    reference keeps them in ``_cw_list`` (``_gdfa`` in gdfa mode)."""
    ms = getattr(sc, "members", None)
    if ms is None:
        ms = [sc._gdfa] if sc.mode == "gdfa" else list(getattr(sc, "_cw_list", []))
    out = []
    for m in ms:
        walk = m if type(m).__name__ == "StrideDfaScanner" else getattr(m, "sc", None)
        plan = None
        if walk is not None:
            t = walk.tables
            plan = (t.mode, t.k, t.n_states, walk.window_mode)
        out.append((type(m).__name__, plan))
    return out


def test_battery_size():
    assert len(_tool.BATTERY) == 39


@pytest.mark.parametrize("pat", _tool.BATTERY, ids=[p.decode("latin-1") for p in _tool.BATTERY])
def test_tier_equals_reference(pat):
    want = _tool.classify(pat, BUF)
    got, sc = port_classify(pat)
    assert got == want
    if sc is not None:
        ref = RefScanner(ref_compile([pat]), buf_size=BUF, pallas_interpret=True)
        assert sc.mode == ref.mode
        ref_members = members(ref)
        if ref.mode == "dfa":  # the reference's jnp walk is no member object
            assert ref_members == [] and members(sc) == [("DfaWalkMember", None)]
        else:
            assert members(sc) == ref_members
    assert port_exact_tier(pat) == _tool.exact_tier(pat)
