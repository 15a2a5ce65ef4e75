"""Golden reference implementations (numpy) that every kernel oracles
against. Slow, obviously-correct, test-only."""

from grab_tpu_torch.golden.scanner import (
    block_counts,
    dfa_scan_ends,
    dfa_scan_ends_fast,
    literal_scan_starts,
)

__all__ = ["dfa_scan_ends", "dfa_scan_ends_fast", "literal_scan_starts", "block_counts"]
