"""Published peaks of the cards the benchmark runs on, by the name that
torch.cuda.get_device_name() gives.

NVIDIA's H100 data sheet, SXM part, at its 700 W limit: 3.35 TB/s of HBM3.
A roofline share counts each input byte read once and each output byte
written once at that rate.
"""

HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_bytes_per_s(kind: str) -> float | None:
    """The card's peak memory rate, or None for a card not in the table."""
    return HBM_BYTES_PER_S.get(kind)
