"""Losses and metrics of the inference path."""

from bmcnet_esr_torch.losses.restore import mse_loss, psnr, psnr_metric, ssim, ssim_metric

__all__ = ["mse_loss", "psnr", "psnr_metric", "ssim", "ssim_metric"]
