"""Published peaks the rooflines are held to, by the device's name as
``torch.cuda.get_device_name()`` gives it. NVIDIA H100 SXM data sheet:
80 GB of HBM3 at 3.35 TB/s, at the full 700 W power limit (a run
records the card's limit beside its numbers)."""

HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_bytes_per_s(kind: str):
    """The card's published memory rate, or None for a card not listed
    (a roofline then reports nothing)."""
    return HBM_BYTES_PER_S.get(kind)
