"""The port's train CLIs launched by torchrun on two gloo ranks on the CPU
(``python -m torch.distributed.run --nproc_per_node=2``) against the same
CLI in one process: the data-parallel run reads the same global batches,
draws the same t, noise and posterior noise and averages the gradients, so
its checkpoint equals the single-process one within f32 summation noise,
and rank 0 alone writes its files.  Both ranks run the port only, on one
thread each, at a lower priority (nice 5), within 120 s.  Two tests: xdist
hands the file out after the slowest file of the suite.
"""
import os
import re
import socket
import subprocess
import sys

import numpy as np
import torch

from diffuscene_tpu_torch.models.autoencoder import BN_MOMENTUM
from diffuscene_tpu_torch.utils.checkpoint import load_checkpoint
from test_torch_ae_cli import N_POINTS, catalog  # noqa: F401 (module fixture)
from test_torch_scene_data import _cli_config
from test_torch_threads import below_the_longest_file  # noqa: F401 (autouse)
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120
# f32, the same arithmetic summed in another order (two halves of each
# batch, an all-reduce): after Adam's first updates (about lr * sign(g)) an
# entry whose gradient lies at the summation noise may step the other way,
# so every entry within 2 steps x 2 lr, all but FLIP_SHARE of them within
# 1e-5 relative + 1e-2 lr.
# An autoencoder entry whose gradient is below 1e-2 of its layer's largest
# (NOISE_REL, by the one-process run's Adam first moment) is held to the
# first bound only: the biases ahead of a BatchNorm, whose true gradient is
# zero, step by about lr in the direction of their rounding noise.
F32_RTOL = 1e-5
FLIP_SHARE = 1e-3
NOISE_REL = 1e-2


def _torchrun(module, args, nproc=2):
    """``module``'s main under torchrun with ``nproc`` gloo ranks."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", f"--nproc_per_node={nproc}",
           "--master_addr=127.0.0.1", f"--master_port={port}", "-m", module, *args]
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=TIMEOUT_S, preexec_fn=lambda: os.nice(5))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert f"data-parallel over {nproc} rank(s), gloo" in proc.stdout
    return proc


def _close(got, want, lr, noise=None):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
    cat = lambda d: np.concatenate([d[k].double().numpy().ravel() for k in want])
    diff, scale = np.abs(cat(got) - cat(want)), np.abs(cat(want))
    assert (diff <= 4 * lr).all(), diff.max()
    kept = np.ones_like(diff, bool) if noise is None else ~cat(noise).astype(bool)
    assert (diff > F32_RTOL * scale + 1e-2 * lr)[kept].mean() <= FLIP_SHARE, diff.max()


def _losses(exp):
    with open(os.path.join(exp, "stats.txt")) as f:
        return [line for line in f.read().splitlines() if line.strip()]


def _compare_runs(one, two, lr, params, noise=None):
    (s1, e1), (s2, e2) = load_checkpoint(one), load_checkpoint(two)
    assert (e1, s1["step"]) == (e2, s2["step"]) and s1["step"] > 0
    _close({k: s2["model"][k] for k in params}, {k: s1["model"][k] for k in params}, lr,
           None if noise is None else noise(s1, params))
    # rank 0 alone appends to stats.txt: as many lines as one process writes
    l1, l2 = _losses(one), _losses(two)
    assert len(l1) == len(l2)
    num = lambda lines: np.array([float(v) for v in re.findall(r"-?\d+\.\d+", " ".join(lines))])
    # the logged values within 1e-5 relative, or their printed last digit
    np.testing.assert_allclose(num(l2), num(l1), rtol=F32_RTOL, atol=1e-5)
    return s1, s2


def test_train_diffusion_two_ranks_equals_one_process(tmp_path):
    """train_diffusion on a synthetic dataset, one epoch (2 steps of a
    global batch of 8, the EMA, a validation pass): 2 gloo ranks x 4
    scenes against one process on 8; the parameters and EMA within the
    bounds above, the Adam count equal, one set of files."""
    from diffuscene_tpu_torch.cli.train_diffusion import main as train_main

    cfg = _cli_config(tmp_path, ema_decay=0.9)
    out = str(tmp_path / "out")
    args = [cfg, out, "--epochs", "1", "--log_every", "1", "--device", "cpu"]
    _torchrun("diffuscene_tpu_torch.cli.train_diffusion", args + ["--experiment_tag", "two"])
    train_main(args + ["--experiment_tag", "one"])
    one, two = os.path.join(out, "one"), os.path.join(out, "two")
    s1, s2 = _compare_runs(one, two, 2e-4, list(s for s in load_checkpoint(one)[0]["model"]))
    _close(s2["ema"], s1["ema"], 2e-4)
    assert s1["optimizer"]["count"] == s2["optimizer"]["count"] == s1["step"]
    assert sorted(os.listdir(one)) == sorted(os.listdir(two))


def test_train_objautoencoder_two_ranks_equals_one_process(catalog, tmp_path):  # noqa: F811
    """train_objautoencoder on a 16-object catalog, one epoch (2 steps of
    a global batch of 8): 2 gloo ranks x 4 clouds, whose train-mode
    BatchNorm moments are summed over the ranks, against one process on
    8; the parameters and running moments within the bounds above, one
    set of files."""
    from diffuscene_tpu_torch.cli.train_objautoencoder import main as train_main

    out = str(tmp_path / "out")
    args = [catalog["cfg"], out, "--path_to_pickled_dataset", catalog["pkl"],
            "--num_samples", str(N_POINTS), "--device", "cpu", "--seed", "3"]
    _torchrun("diffuscene_tpu_torch.cli.train_objautoencoder", args + ["--experiment_tag", "two"])
    train_main(args + ["--experiment_tag", "one"])
    one, two = os.path.join(out, "one"), os.path.join(out, "two")
    state = load_checkpoint(one)[0]["model"]
    params = [k for k, v in state.items() if v.is_floating_point() and "running" not in k]

    def noise(s, names):
        mu = dict(zip(names, (m.abs() for m in s["optimizer"]["slots"][0])))
        top = {}
        for k, m in mu.items():
            layer = k.rsplit(".", 1)[0]
            top[layer] = max(top.get(layer, 0.0), float(m.max()))
        return {k: m <= NOISE_REL * top[k.rsplit(".", 1)[0]] for k, m in mu.items()}

    lr = 1e-4
    s1, s2 = _compare_runs(one, two, lr, params, noise)
    # the second step's moments are taken with the first step's parameters,
    # which may differ by 2 lr an entry (above): the running moments within
    # 1e-3 relative + (1 - momentum) x 4 lr
    for k, v in s1["model"].items():
        if "running" in k:
            torch.testing.assert_close(s2["model"][k], v, rtol=1e-3,
                                       atol=(1 - BN_MOMENTUM) * 4 * lr)
        elif k.endswith("num_batches_tracked"):
            assert int(s2["model"][k]) == int(v) == 2, k
    assert sorted(os.listdir(one)) == sorted(os.listdir(two))
