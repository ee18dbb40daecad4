"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W power limit). Every roofline and
`_mfu` share of this benchmark divides by these numbers; a card set below
700 W reaches less, so each run prints the card's `power.limit` beside
its shares."""

HBM_BYTES_PER_S = 3.35e12        # HBM3
BF16_FLOPS_PER_S = 989e12        # tensor cores, dense
F32_FLOPS_PER_S = 67e12          # outside the tensor cores
PCIE_BYTES_PER_S = 64e9          # PCIe Gen5 x16, one direction
