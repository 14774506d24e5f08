"""Published peaks of the cards the benchmark knows, by the name
``torch.cuda.get_device_name`` gives: NVIDIA's data sheet, SXM part,
dense rates, at the full 700 W power limit."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def fp32_flops(kind: str):
    """The card's fp32 rate outside the tensor cores, or None for a card
    the table does not hold."""
    return PEAKS.get(kind, {}).get("fp32_flops")
