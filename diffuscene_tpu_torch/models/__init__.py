from .denoiser import Unet1D, init_parameters
from .scene_model import ConditionNets, SceneDiffusion, SceneModelConfig, build_unet1d
from .autoencoder import AutoEncoder, KLAutoEncoder, build_autoencoder, kl_autoencoder_loss
