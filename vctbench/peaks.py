"""Published peaks by torch.cuda.get_device_name (NVIDIA's data sheet,
H100 SXM, dense rates without sparsity, at the full 700 W): the HBM's
bytes a second and float32 operations a second outside the tensor cores
(a fused multiply-add counted as two).  A card not listed has no
roofline: its readers return nothing."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flops_per_s": 67e12},
}
