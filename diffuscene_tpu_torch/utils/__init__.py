from .convert import (denoiser_tree, flax_to_torch_autoencoder, flax_to_torch_denoiser,
                      load_jax_autoencoder, load_jax_params, scene_tree)
from .checkpoint import (latest_epoch, load_checkpoint, load_model_weights, save_bounds,
                         save_checkpoint)
from .config import load_config, parse_yaml, save_experiment_params
from .stats_logger import AverageAggregator, StatsLogger
