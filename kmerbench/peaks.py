"""The card's published peaks (NVIDIA H100 SXM data sheet, dense rates,
at its full 700 W power limit).  A roofline share states the card's power
limit beside it."""

HBM_BYTES_PER_S = 3.35e12
