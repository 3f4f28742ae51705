from .denoiser import Unet1D, init_parameters
from .scene_model import ConditionNets, SceneDiffusion, SceneModelConfig, build_unet1d
