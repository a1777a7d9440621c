"""The yardstick's arithmetic: model FLOPs, kernel bytes and FLOPs, and the
card's data-sheet peaks.  Everything is worked from shapes; nothing here is
measured."""

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
