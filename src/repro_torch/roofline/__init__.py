from repro_torch.roofline.analysis import train_flops_per_step

__all__ = ["train_flops_per_step"]
