"""Losses and metrics: restoration metrics, LPIPS and its calibration
trainer, the event-warping and brightness-constancy losses, and the terms a
training recipe's ``loss:`` block attaches (``losses/terms.py``)."""

from bmcnet_esr_torch.losses.restore import mse_loss, psnr, psnr_metric, ssim, ssim_metric
from bmcnet_esr_torch.losses.lpips import (
    LPIPS,
    DistanceModel,
    dssim_distance,
    l2_distance,
    perceptual_loss,
    resnet_features,
)
from bmcnet_esr_torch.losses.lpips_train import (
    LPIPSTrainer,
    bce_ranking_loss,
    compute_accuracy,
    dist2logit,
    init_dist2logit,
    score_2afc_dataset,
    score_jnd_dataset,
    voc_ap,
)
from bmcnet_esr_torch.losses.iwe import (
    compute_pol_iwe,
    deblur_events,
    events_to_iwe_order,
    get_interpolation,
    interpolate,
    purge_unfeasible,
)
from bmcnet_esr_torch.losses.flow import averaged_iwe, event_warping_loss
from bmcnet_esr_torch.losses.gradients import sobel
from bmcnet_esr_torch.losses.terms import LossContext
from bmcnet_esr_torch.losses.reconstruction import (
    BrightnessConstancy,
    generative_model_loss,
    temporal_consistency_loss,
    total_variation_loss,
)

__all__ = [
    "LPIPS",
    "DistanceModel",
    "dssim_distance",
    "l2_distance",
    "perceptual_loss",
    "resnet_features",
    "LPIPSTrainer",
    "bce_ranking_loss",
    "compute_accuracy",
    "dist2logit",
    "init_dist2logit",
    "score_2afc_dataset",
    "score_jnd_dataset",
    "voc_ap",
    "mse_loss",
    "psnr",
    "psnr_metric",
    "ssim",
    "ssim_metric",
    "compute_pol_iwe",
    "deblur_events",
    "events_to_iwe_order",
    "get_interpolation",
    "interpolate",
    "purge_unfeasible",
    "averaged_iwe",
    "event_warping_loss",
    "sobel",
    "BrightnessConstancy",
    "generative_model_loss",
    "temporal_consistency_loss",
    "total_variation_loss",
    "LossContext",
]
