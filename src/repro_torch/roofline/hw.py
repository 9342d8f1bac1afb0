"""NVIDIA H100 hardware constants (per card) — roofline targets.

Each is a data-sheet figure of the "NVIDIA H100 80GB HBM3" (the SXM5 part:
dense rates, no sparsity, at its full 700 W power limit); a card set below
700 W runs slower under load, so a roofline share is stated beside the
card's power limit.  The reference's ``hw.py`` holds a TPU's instead.
"""

#: the card these constants describe (``torch.cuda.get_device_name``)
DEVICE_NAME = "NVIDIA H100 80GB HBM3"
PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 on the tensor cores
PEAK_FLOPS_FP32 = 67e12  # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12  # B/s, HBM3
#: B/s per direction of NVLink 4 (18 links × 25 GB/s): the collective term's
#: wire rate between cards
NVLINK_BW = 450e9
ICI_BW = NVLINK_BW  # the reference's name for the interconnect term
HBM_BYTES = 80 * 10**9  # device memory (80 GB)
