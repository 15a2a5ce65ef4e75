"""tpugrep — grab-compatible CLI front end, PyTorch/CUDA port.

Usage: ``python -m grab_tpu_torch.cli [flags] <pattern> <path>...``.
Stdout is byte-identical to the JAX package's ``grab_tpu.cli``. The
scan runs on the CUDA card; GRAB_TPU_TORCH_DEVICE=cpu runs the
kernels' plain PyTorch versions on the CPU instead, and a
comma-separated list of torch devices names the -n N shard devices.
``--via <socket>`` as the first argument sends the rest to a running
scan server (grab_tpu_torch.server). ``--hosts N --pid P --coordinator
HOST:PORT -r`` runs one host of a multi-host scan (parallel/hostrun.py,
over torch.distributed); without -r, multi-host gets the reference's own
refusal.

Flag surface mirrors the reference exactly
(greppin src/main.cc:103-161 + greppin extensions,
README.md:16-31):

  -r/-R   recursive
  -I      ANSI reverse-video highlight (only if stdout is a tty)
  -O      print "Match at offset N" lines
  -L      low-memory: halve chunk size (floor 32 MiB, main.cc:131-135)
  -l      no line printing ("matches" per chunk unless -O)
  -s      single match per file
  -n N    parallel scan over N workers (reference: cores; here: device
          shards, capped at the shard devices present — requires -r,
          main.cc:167-170; chunk quartered, main.cc:172-173)
  -2      PCRE2 semantics (greppin, README.md:18)
  -S      literal (fixed-string) mode (greppin, README.md:25-26)
  -H      multi-pattern batch mode: the pattern argument is a file with
          one pattern per line (hyperscan batch, README.md:63-92)
  -E      exact mode (ours): one logical chunk per file — no
          4 KiB-overlap duplicates and no missed chunk-spanning
          matches (the reference's documented limitation,
          README.md:116-119)
  --stats print scan statistics to stderr (off the parity path), with
          the request's spans (engine.py ScanStats)
  --trace D
          torch.profiler trace of the whole scan, written to
          D/trace.json (Chrome trace format); the spans are host ranges
          in it
  --hosts N --pid P --coordinator HOST:PORT, --outdir D
          multi-host mode (BASELINE config 5), recursive only: one
          command per host; host 0 serves the store on HOST:PORT and
          prints the globally ordered output, --outdir is the shared
          directory for outputs beyond the gather cap

Exit codes follow the reference: 0 on success regardless of matches,
255 on setup errors (SURVEY §3.5).
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

from grab_tpu_torch.engine import Engine, EngineConfig
from grab_tpu_torch.format.emitter import OutputConfig
from grab_tpu_torch.scan_pipeline import DeviceUnavailable

USAGE = "Usage: {p} [-rR] [-I] [-O] [-L] [-l] [-s] [-n <cores>] [-2] [-S] [-H] [-E] <regex> <path>\n"

MIN_CHUNK = 1 << 25  # 32 MiB floor (main.cc:134-135)


def parse_args(argv: List[str]):
    """getopt-style parser for 'Rrn:IOlsL2SH' plus --stats."""
    opts = {
        "recursive": False,
        "color": False,
        "offsets": False,
        "noline": False,
        "single": False,
        "low_mem": False,
        "cores": 0,
        "pcre2": False,
        "exact": False,
        "literal": False,
        "multi": False,
        "stats": False,
        "resume": None,
        "trace": None,
        "hosts": 0,
        "pid": None,
        "coordinator": None,
        "outdir": None,
    }
    chunk_size = 1 << 30
    args = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--stats":
            opts["stats"] = True
        elif a == "--resume":
            i += 1
            opts["resume"] = argv[i]
        elif a == "--trace":
            # torch.profiler trace of the whole scan (SURVEY §5): a
            # Chrome trace in the given directory; off the parity path
            i += 1
            opts["trace"] = argv[i]
        elif a == "--hosts":
            # BASELINE config 5: one command per host
            i += 1
            opts["hosts"] = int(argv[i])
        elif a == "--pid":
            i += 1
            opts["pid"] = int(argv[i])
        elif a == "--coordinator":
            i += 1
            opts["coordinator"] = argv[i]
        elif a == "--outdir":
            # shared-dir fallback for outputs beyond the gather cap
            i += 1
            opts["outdir"] = argv[i]
        elif a == "--":
            args.extend(argv[i + 1 :])
            break
        elif a.startswith("-") and len(a) > 1 and not args:
            j = 1
            while j < len(a):
                c = a[j]
                if c in "rR":
                    opts["recursive"] = True
                elif c == "I":
                    opts["color"] = True
                elif c == "O":
                    opts["offsets"] = True
                elif c == "l":
                    opts["noline"] = True
                elif c == "s":
                    opts["single"] = True
                elif c == "L":
                    opts["low_mem"] = True
                    chunk_size >>= 1
                    if chunk_size < MIN_CHUNK:
                        chunk_size = MIN_CHUNK
                elif c == "2":
                    opts["pcre2"] = True
                elif c == "E":
                    # exact mode (ours, not in the reference): one
                    # logical chunk per file — no 4 KiB-overlap
                    # duplicate reports and no missed matches spanning
                    # chunk boundaries (the reference's documented
                    # limitation, README.md:116-119 / grab.cc:151-154)
                    opts["exact"] = True
                elif c == "S":
                    opts["literal"] = True
                elif c == "H":
                    opts["multi"] = True
                elif c == "n":
                    if j + 1 < len(a):
                        opts["cores"] = int(a[j + 1 :])
                        j = len(a)
                    else:
                        i += 1
                        opts["cores"] = int(argv[i])
                else:
                    return None, None, None
                j += 1
        else:
            args.append(a)
        i += 1
    return opts, chunk_size, args


class _TorchTrace:
    """torch.profiler over the scan (CPU, plus CUDA when a card is
    visible); the Chrome trace goes to ``<directory>/trace.json``, with
    the request's id as its ``request`` metadata. While it runs the
    request's spans (``stats``) are also profiler ranges."""

    def __init__(self, directory: str, stats):
        self.directory = directory
        self.stats = stats
        self._prof = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._prof.add_metadata("request", str(self.stats.request))
        self.stats.tracing = True
        return self

    def __exit__(self, *exc):
        self.stats.tracing = False
        self._prof.__exit__(*exc)
        os.makedirs(self.directory, exist_ok=True)
        self._prof.export_chrome_trace(os.path.join(self.directory, "trace.json"))
        return False


def main(
    argv: Optional[List[str]] = None, out=None, err=None, engine_factory=None,
    request: int = 0,
) -> int:
    """CLI entry. ``out`` is a binary writer (default: stdout.buffer),
    ``err`` a text writer (default: stderr), ``engine_factory`` an
    Engine-compatible constructor, ``request`` the request's id in the
    --stats line and the trace (the scan server's count)."""
    argv = sys.argv[1:] if argv is None else argv
    prog = "tpugrep"
    # adopt LC_CTYPE like the reference's C runtime: pattern classes
    # (\w \s \d, POSIX, \b) follow the environment locale
    # (pcre_maketables parity, grab.cc:106; regex/ctype)
    from grab_tpu_torch.regex import ctype as _ctype

    _ctype.activate_from_environment()
    if argv[:1] == ["--via"]:
        # route through a running scan server (grab_tpu_torch.server):
        # its warm scanners save a repeat scan the kernels' build and
        # load and the scanner's tables
        from grab_tpu_torch.server import client

        if len(argv) < 2:
            print("tpugrep: --via needs a socket path", file=err or sys.stderr)
            return 255
        return client(argv[1], argv[2:])
    is_tty = sys.stdout.isatty() if out is None else bool(
        getattr(out, "isatty", lambda: False)()
    )
    if out is None:
        out = sys.stdout.buffer
    if err is None:
        err = sys.stderr
    opts, chunk_size, args = parse_args(argv)
    if opts is None or len(args) < 2:
        out.write(USAGE.format(p=prog).encode())
        return 1

    pattern_arg, paths = args[0], args[1:]

    if opts["cores"] > 1 and not opts["recursive"]:
        print("Multicore support only for recursive grabs.", file=err)
        return 255
    if opts["cores"] > 1:
        chunk_size >>= 2  # main.cc:172-173
    if opts["exact"]:
        chunk_size = 1 << 62  # one chunk per file: exact, no duplicates

    out_cfg = OutputConfig(
        colored=opts["color"] and is_tty,
        print_line=not opts["noline"],
        print_offset=opts["offsets"],
        single_match=opts["single"],
        recursive=opts["recursive"],
        print_path=len(paths) > 1,
        chunk_size=chunk_size,
    )
    mode = "literal" if opts["literal"] else ("pcre2" if opts["pcre2"] else "pcre1")
    cfg = EngineConfig(
        output=out_cfg,
        mode=mode,
        n_shards=max(1, opts["cores"]),
        exact=opts["exact"],
        record=opts["stats"] or bool(opts["trace"]),
    )

    if opts["multi"]:
        # -H: pattern argument is a file of patterns, one per line
        try:
            with open(pattern_arg, "rb") as f:
                patterns = [ln for ln in f.read().splitlines() if ln]
        except OSError as e:
            print(f"{pattern_arg}: {e.strerror}", file=err)
            return 255
    else:
        patterns = [pattern_arg.encode("utf-8", "surrogateescape")]

    try:
        engine = (engine_factory or Engine)(patterns, cfg)
    except DeviceUnavailable as e:
        print(f"tpugrep: {e}", file=err)
        return 255
    except Exception as e:
        print(f"tpugrep: pattern compile error: {e}", file=err)
        return 255

    def emit(buf: bytes):
        out.write(buf)

    import time
    from contextlib import nullcontext

    engine.stats.request = request
    trace_ctx = nullcontext()
    if opts["trace"]:
        trace_ctx = _TorchTrace(opts["trace"], engine.stats)

    t0 = time.time()
    nbytes = 0

    manifest = None
    if opts["resume"]:
        from grab_tpu_torch.resume import ResumeManifest

        manifest = ResumeManifest(opts["resume"])

    multihost = bool(
        opts["hosts"] or os.environ.get("JAX_NUM_PROCESSES")
    )
    if multihost and not opts["recursive"]:
        print("Multihost support only for recursive grabs.", file=err)
        return 255

    with trace_ctx:
        if multihost:
            from grab_tpu_torch.parallel.hostrun import run_multihost

            rc = run_multihost(
                engine,
                paths[0],
                emit,
                err=err,
                coordinator=opts["coordinator"],
                num_processes=opts["hosts"] or None,
                process_id=opts["pid"],
                outdir=opts["outdir"],
                stats=opts["stats"],
            )
            out.flush()
            return rc
        if opts["recursive"]:
            if opts["cores"] > 1 and manifest is None:
                from grab_tpu_torch.parallel.runner import run_parallel

                nbytes = run_parallel(engine, paths[0], emit, opts["cores"])
            else:
                engine.find_recursive(paths[0], emit, manifest=manifest)
        else:
            for p in paths:
                if engine.scan_file(p, emit) < 0:
                    print(f"{engine.err}", file=err)
                    return 255
    out.flush()

    if opts["stats"]:
        dt = time.time() - t0
        print(
            f"tpugrep: {dt:.3f}s"
            + (f", {nbytes / dt / 1e9:.2f} GB/s" if nbytes else "")
            + f" | {engine.stats.summary()}",
            file=err,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
