"""spot — parallel find(1) companion tool.

The greppin branch ships `spot`, a parallel file finder built on the
same lockfree parallel nftw walker (greppin README.md:144-148:
``spot -n 4 / 'secret.*\\.doc'``). This is its counterpart on our
ingest stack: the native C++ walker (gt_pwalk thread pool for -n > 1,
deterministic serial-order output) enumerates the tree, and the
pattern engine — the same compiler the scan engine uses — matches
*path names* instead of file contents.

Usage: python -m grab_tpu_torch.spot [-n <workers>] <start-dir> <regex>
"""

from __future__ import annotations

import sys
from typing import List, Optional

from grab_tpu_torch.ingest import native
from grab_tpu_torch.ingest.walker import walk_files
from grab_tpu_torch.regex.backtrack import Matcher


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    workers = 0
    args = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-n":
            i += 1
            workers = int(argv[i])
        elif a.startswith("-n"):
            workers = int(a[2:])
        else:
            args.append(a)
        i += 1
    if len(args) != 2:
        sys.stdout.write("Usage: spot [-n <cores>] <start-dir> <regex>\n")
        return 1
    root, pattern = args
    try:
        matcher = Matcher.from_pattern(pattern.encode("utf-8", "surrogateescape"))
    except Exception as e:
        print(f"spot: pattern compile error: {e}", file=sys.stderr)
        return 255

    out = sys.stdout
    entries = native.walk_native(root, workers=max(1, workers))
    if entries is None:
        entries = [(e.path, e.size) for e in walk_files(root)]
    for path, _size in entries:
        pb = path.encode("utf-8", "surrogateescape")
        if matcher.search(pb, 0, len(pb)) is not None:
            out.write(path + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
