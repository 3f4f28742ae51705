from .convert import denoiser_tree, flax_to_torch_denoiser, load_jax_params
