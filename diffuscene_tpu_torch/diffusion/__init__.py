from .schedule import DiffusionSchedule, extract, get_betas, make_schedule, schedule_from_betas
from .gaussian import (
    AttributeSpec,
    LossConfig,
    ModelPrediction,
    iou_regularizer,
    model_predictions,
    p_losses,
    p_mean_variance,
    predict_eps_from_xstart,
    predict_v,
    predict_xstart_from_eps,
    predict_xstart_from_v,
    q_posterior_mean_variance,
    q_sample,
)
from .samplers import ddim_sample_loop, dpm_solver_sample_loop, p_sample_loop, p_sample_step
