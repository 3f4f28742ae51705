"""Two port Trainer steps of the flagship's training block against the JAX
package (tests/test_torch_train.py's ``two_trainer_steps_against_jax``,
whose module docstring states the method and the tolerances; a file of its
own so that the test runner's file scheduler starts it beside the long JAX
files, not before them)."""
from test_torch_threads import below_the_longest_file  # noqa: F401 (autouse)
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)
from test_torch_train import two_trainer_steps_against_jax


def test_two_trainer_steps_match_jax():
    """The flagship's training block: f32, clip + Adam, step schedule
    (the b512 recipe's in tests/test_torch_train_b512.py)."""
    two_trainer_steps_against_jax("flagship")

