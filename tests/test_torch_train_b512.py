"""Two port Trainer steps of the b512 recipe's training block against the
JAX package (a file of its own: its bf16 JAX step takes most of a minute to
compile on the CPU).  The recipe: a bf16 net with ws_fast_vjp and tanh
GELU, fused clip + Adam with bf16 moments, bf16 gradients, a bf16 EMA; the
tolerances are stated in tests/test_torch_train.py."""
from test_torch_train import two_trainer_steps_against_jax
from test_torch_threads import below_the_longest_file  # noqa: F401 (autouse)
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


def test_two_trainer_steps_match_jax_b512_recipe():
    two_trainer_steps_against_jax("b512")
