"""The scan pipeline's own rate: bytes scanned over the scan's wall
(--stats bytes= and scan=), summed over the traced requests, in GB/s."""


def read(run):
    rs = [r.stats for r in run.requests if r.rc == 0 and r.stats is not None]
    wall = sum(s.scan_s for s in rs)
    if not rs or wall <= 0:
        return None
    return sum(s.bytes for s in rs) / wall / 1e9
