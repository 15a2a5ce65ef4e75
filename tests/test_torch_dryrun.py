"""The port's entry point and multi-device dry run against the JAX package's.

``grab_tpu_torch.dryrun`` on the CPU (the kernels' plain PyTorch
versions; a comma-separated device list gives several CPU lanes) against
``__graft_entry__.py`` (loaded from its file) on CPU JAX with the
conftest's 8 virtual devices. Tolerance: 0 — integer counts and stdout
bytes.
"""

import importlib.util
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grab_tpu_torch import dryrun
from tests._torch_threads import _one_thread  # noqa: F401 (autouse: one intra-op thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU4 = "cpu,cpu,cpu,cpu"


def _reference():
    spec = importlib.util.spec_from_file_location(
        "grab_tpu_graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_equals_reference():
    fn, args = _reference().entry()
    ref = tuple(int(x) for x in jax.jit(fn)(*args))
    pfn, pargs = dryrun.entry("cpu")
    got = tuple(int(x) for x in pfn(*pargs))
    assert ref == (1, 2)
    assert got == ref


def test_dryrun_multichip_on_four_cpu_lanes():
    out = io.StringIO()
    res = dryrun.dryrun_multichip(4, CPU4, out=out)
    ratio = json.loads(out.getvalue().splitlines()[0])
    assert ratio["metric"] == "shard_orchestration_overhead_ratio"
    assert ratio["n_shards"] == 4 and ratio["value"] > 0
    assert res["engine"]["lines"] > 0
    assert res["scan_step"]["total"] >= 4 and res["word_scan"]["total"] >= 4


def test_engine_part_equals_reference_engine():
    from grab_tpu.engine import Engine, EngineConfig
    from grab_tpu.format.emitter import OutputConfig

    corpus = dryrun.dryrun_corpus(4)
    cfg = EngineConfig(output=OutputConfig(recursive=True), scan_buf_size=64 << 10, n_shards=4)
    ref = bytearray()
    Engine([dryrun.FLAGSHIP], cfg).scan_corpus(iter(corpus), ref.extend)
    got = dryrun.engine_part(4, CPU4)
    assert ref and got["output"] == bytes(ref)
    assert got["lines"] == ref.count(b"\n")


def test_scan_step_part_equals_reference():
    from jax.sharding import NamedSharding, PartitionSpec as P

    from grab_tpu.parallel.scan_step import make_mesh, make_sharded_scan
    from grab_tpu.regex.compiler import compile_pattern

    mesh = make_mesh(4)
    fn = make_sharded_scan(compile_pattern(dryrun.FLAGSHIP), mesh, dryrun.SHARD_BYTES)
    data = jax.device_put(jnp.asarray(dryrun.needle_buffer(4)), NamedSharding(mesh, P("shards")))
    counts, total = fn(data)
    got = dryrun.scan_step_part(["cpu"] * 4)
    assert got["total"] == int(total) >= 4
    assert got["flagged_blocks"] == int((np.asarray(counts) > 0).sum())


def test_word_scan_part_equals_reference():
    from jax.sharding import NamedSharding, PartitionSpec as P

    from grab_tpu.ops.pallas_corewords import BLOCK, LANES, PAD_ROWS, decode_packed_flags
    from grab_tpu.parallel.scan_step import make_mesh, make_sharded_word_scan

    mesh = make_mesh(4)
    shard_rows = dryrun.SHARD_BYTES // BLOCK
    wfn = make_sharded_word_scan([dryrun.NEEDLE], mesh, shard_rows, interpret=True)
    buf = dryrun.needle_buffer(4)
    shards = [np.concatenate([buf[d * dryrun.SHARD_BYTES : (d + 1) * dryrun.SHARD_BYTES]
                              .view("<i4").reshape(shard_rows, LANES),
                              np.zeros((PAD_ROWS, LANES), "<i4")]) for d in range(4)]
    words3d = jax.device_put(jnp.asarray(np.stack(shards)),
                             NamedSharding(mesh, P("shards", None, None)))
    packed, total = wfn(words3d)
    t = wfn.tests
    flags0 = decode_packed_flags(np.asarray(packed)[0], shard_rows, t.probe_back, t.probe_fwd)
    got = dryrun.word_scan_part(["cpu"] * 4)
    assert got["total"] == int(total) >= 4
    assert got["flagged0"] == np.flatnonzero(flags0).tolist()
    assert 100 // BLOCK in got["flagged0"]


def test_lane_count_is_never_capped():
    # two devices named: -n 4 would run two lanes, so the part refuses
    with pytest.raises(RuntimeError, match="built 2 lane"):
        dryrun.engine_part(4, "cpu,cpu")
    with pytest.raises(ValueError, match="3 shard devices asked for"):
        dryrun.dryrun_multichip(3, "cpu,cpu", out=io.StringIO())


def test_main_needs_a_card_unless_the_cpu_is_named(monkeypatch, capsys):
    monkeypatch.delenv("GRAB_TPU_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)  # no card, even on one
    assert dryrun.main(["2"]) == 2
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err
    assert dryrun.main(["2", "--device", "cpu,cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("entry OK: 1 nonzero bitmap words, 2 walks\n")
    assert "shard_orchestration_overhead_ratio" in out
