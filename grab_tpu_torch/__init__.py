"""grab_tpu_torch — the PyTorch/CUDA port of grab_tpu for NVIDIA Hopper.

A second package beside the JAX one: the same CLI surface and the same
stdout, byte for byte, with each TPU kernel on the served path replaced
by a kernel written by hand for the H100 (``csrc/``, built at first use
by ``_build.py``). It imports torch, never jax, and nothing of
grab_tpu: the host layers it needs are its own copies.

Package layout:
  regex/          pattern parser, NFA/DFA compiler, exact matchers (copy)
  ops/            GPU kernels' wrappers + plain PyTorch versions
                  (alpharun.py also holds the compiler's numpy planner)
  csrc/           CUDA C++ kernel sources (sm_90a)
  ingest/         corpus walker + batch packer + native pread/walk library
  format/         reference-exact output grammar (copy)
  scan_pipeline.py  DeviceScanner (device routing, 1..N lanes), the lanes'
                  upload slots + CorpusPipeline
  parallel/       -n N: shard devices, the runner, multi-host
  engine.py       orchestrator (the FileGrep equivalent)
  cli.py          `tpugrep` command-line front end
  server.py       scan server with warm scanners (`tpugrep --via <socket>`)

The scan runs on the CUDA card unless the caller asks for the CPU
(``EngineConfig(device="cpu")`` or GRAB_TPU_TORCH_DEVICE=cpu), where
each kernel's plain PyTorch version runs instead; ``device="none"`` is
the pure host scan, and a comma-separated list of torch devices names
the -n N shard devices one by one.
"""

__version__ = "0.1.0"
