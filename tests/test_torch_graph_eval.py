"""The port's eval steps as bodies over device buffers, run from a CUDA graph
on the card (diffuscene_tpu_torch/train/trainer.py, train/ae_trainer.py,
utils/graphs.py): the counterpart of the JAX package's jitted ``_eval_step``
(diffuscene_tpu/train/trainer.py:200-217, ae_trainer.py:71-93).

The eager eval steps compute what is held against the JAX package
elsewhere: the scene step the loss the train step differentiates
(tests/test_torch_losses.py, test_torch_train_steps.py), the AE step the
eval-mode posterior, decode and loss (test_torch_autoencoder.py).  Here the
graph
path, driven through tests/test_torch_graph_train.py's eager stand-in for
the capture (each replay runs the body and copies its outputs into static
tensors), is held against the eager ``eval_step`` of a twin trainer from
the same seed, bit for bit (every step's metrics, the generator's state,
the trainer's state): the scene step at dim 64 in f32 and the room-mask
model (t and noise drawn inside the graph, and given), the AE step (eval
mode, the posterior mean), a ragged last batch as a variant of its own
beside the train step's graphs, the chamfer kernel's launches under a
simulated capture, and the trainers that stay eager.
"""
import contextlib

import numpy as np
import pytest
import torch

from diffuscene_tpu_torch.models import SceneDiffusion
from diffuscene_tpu_torch.models.autoencoder import KLAutoEncoder
from diffuscene_tpu_torch.ops import build, chamfer
from diffuscene_tpu_torch.parallel import Mesh
from diffuscene_tpu_torch.train import ae_trainer as ae_mod
from diffuscene_tpu_torch.train.ae_trainer import AETrainer
from diffuscene_tpu_torch.train.trainer import Trainer
from diffuscene_tpu_torch.utils import graphs
from test_torch_graph_train import (AE_B, AE_POINTS, B, BOUNDS, FLAGSHIP, _ae_state, _configs,
                                    _EagerStepGraph, _equal, _FakeGraph, _scene_inputs,
                                    _scene_state, _scene_trainer, _stand_in, _training)
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


def _eval_inputs(case, seed=9):
    """Eval batches: a full batch three times (warm, capture, replay), with t
    and noise given twice, and a ragged last batch twice."""
    full, ragged = (2, 1) if case == "room_mask" else (B, 3)
    return _scene_inputs(case, [(full, False)] * 3 + [(full, True)] * 2
                         + [(ragged, False)] * 2, seed=seed)


@pytest.mark.parametrize("case", ["radam", "room_mask"])
def test_graphed_scene_eval_step_is_the_eager_one(case, monkeypatch):
    """After one train step, the eval steps from the graph path (one variant
    a batch shape and a given or drawn t and noise) equal the eager
    eval_step bit for bit, and leave the trainer's state as the eager ones
    do, the generator's included."""
    train = _scene_inputs(case, [(2 if case == "room_mask" else B, False)], seed=4)
    evals = _eval_inputs(case)

    def run(graph):
        tr = _scene_trainer(case, graph)
        for host, t, noise in train:
            tr.train_step(tr.put_batch(host), t, noise)
        ms = [tr.eval_step(tr.put_batch(host), t, noise) for host, t, noise in evals]
        return ms, _scene_state(tr), tr

    eager_metrics, eager_state, _ = run(False)
    _stand_in(monkeypatch)
    graph_metrics, graph_state, tr = run(True)
    assert graph_metrics == eager_metrics
    _equal(graph_state, eager_state)
    # the train step's variant and three eval variants: full drawn, full
    # given, ragged drawn
    assert sorted(str(k) for k, _, _ in tr.step_graphs.costs) == ["True"] + ["eval"] * 3
    assert _EagerStepGraph.replays == 2 + 1 + 1


def test_graphed_ae_eval_step_is_the_eager_one(monkeypatch):
    """The AE eval step (eval mode: running BatchNorm moments, the
    posterior mean, no backward) from the graph path, after a train step,
    equals the eager eval_step bit for bit on full and ragged batches, and
    changes no parameter, buffer or generator state."""
    rng = np.random.default_rng(10)
    clouds = [rng.uniform(-0.5, 0.5, (b, AE_POINTS, 3)).astype(np.float32)
              for b in (AE_B, AE_B, AE_B, 1, 1)]
    train = rng.uniform(-0.5, 0.5, (AE_B, AE_POINTS, 3)).astype(np.float32)

    def run(graph):
        tr = AETrainer(KLAutoEncoder(latent_dim=32, device="cpu"), _training(FLAGSHIP),
                       steps_per_epoch=3, device="cpu", graph=graph).init(4)
        tr.train_step(tr.put_batch(train))
        before = _ae_state(tr)
        ms = [tr.eval_step(tr.put_batch(pc)) for pc in clouds]
        _equal(_ae_state(tr), before)
        return ms, _ae_state(tr)

    eager_metrics, eager_state = run(False)
    _stand_in(monkeypatch)
    graph_metrics, graph_state = run(True)
    assert graph_metrics == eager_metrics
    _equal(graph_state, eager_state)
    assert _EagerStepGraph.replays == 3            # 2 of the full batch, 1 of the ragged one


def test_eval_variants_beside_the_train_graphs(monkeypatch):
    """The train CLI's pattern, an epoch of train steps, a validation pass
    with a ragged last batch, then more train steps: from the graph path,
    every step's metrics and the final state equal the eager trainer's,
    bit for bit; the eval graphs leave the train step's graph as it was."""
    steps = ([("train", x) for x in _scene_inputs("radam", [(B, False)] * 3, seed=11)]
             + [("eval", x) for x in _scene_inputs("radam", [(B, False)] * 2 + [(2, False)],
                                                   seed=12)]
             + [("train", x) for x in _scene_inputs("radam", [(B, False)] * 2, seed=13)])

    def run(graph):
        tr = _scene_trainer("radam", graph)
        ms = [(tr.train_step if kind == "train" else tr.eval_step)(tr.put_batch(host), t, noise)
              for kind, (host, t, noise) in steps]
        return ms, _scene_state(tr)

    eager_metrics, eager_state = run(False)
    _stand_in(monkeypatch)
    graph_metrics, graph_state = run(True)
    assert graph_metrics == eager_metrics
    _equal(graph_state, eager_state)
    # train: 4 replays after its warm step; eval: 1 of the full batch
    assert _EagerStepGraph.replays == 5


def test_chamfer_launches_of_the_graphed_ae_eval_step(monkeypatch):
    """An AE trainer's eval step on the graph path with torch.cuda stubbed so
    that the capture runs on the CPU (each chamfer direction counting as a
    launch): the warm step counts its 2, the capture tallies 2 and counts
    none, each replay adds 2, so n eval steps count 2n; the tally of the
    eval graph is the chamfer's 2."""
    capturing = [False]

    @contextlib.contextmanager
    def graph(g, **kw):
        capturing[0] = True
        try:
            yield
        finally:
            capturing[0] = False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    monkeypatch.setattr(graphs, "on_side_stream", lambda fn, device: (fn(), None))
    monkeypatch.setattr(ae_mod, "use_graph",
                        lambda graph, device, noise_fn=None, uncapturable=None: bool(graph))
    plain = chamfer.directed_nn_reference

    def launched(x, y):
        build.count_launch(chamfer.directed_nn)
        return plain(x, y)

    monkeypatch.setattr(chamfer, "directed_nn_reference", launched)
    monkeypatch.setattr(chamfer.directed_nn, "launches", 0)
    made = build.prepared.made
    tr = AETrainer(KLAutoEncoder(latent_dim=32, device="cpu"), _training(FLAGSHIP),
                   device="cpu", graph=True).init(4)
    pc = tr.put_batch(np.random.default_rng(14).uniform(-0.5, 0.5, (AE_B, AE_POINTS, 3)))
    counts = []
    for _ in range(4):
        m = tr.eval_step(pc)
        counts.append(chamfer.directed_nn.launches)
    assert counts == [2, 4, 6, 8] and np.isfinite(m["loss"])
    (step,) = tr.step_graphs._steps.values()
    assert dict(step[1].graph.tally) == {(chamfer.directed_nn, None): 2}
    assert build.prepared.made == made


def test_eval_steps_stay_eager_without_a_graph(monkeypatch):
    """graph=False, the CPU (graph=None) and a distributed mesh run the eval
    step eagerly: no variant is made, in both trainers."""
    def refuse(*args, **kw):
        raise AssertionError("an eager trainer reached the graph path")

    monkeypatch.setattr(graphs.GraphedSteps, "__call__", refuse)
    host, _, _ = _scene_inputs("radam", [(B, False)])[0]
    for graph in (False, None):
        tr = _scene_trainer("radam", graph)
        assert not tr.graph
        assert np.isfinite(tr.eval_step(tr.put_batch(host))["loss"])
        ae = AETrainer(KLAutoEncoder(latent_dim=32, device="cpu"), _training(FLAGSHIP),
                       device="cpu", graph=graph).init(4)
        pc = ae.put_batch(np.random.default_rng(15).uniform(-0.5, 0.5, (AE_B, AE_POINTS, 3)))
        assert np.isfinite(ae.eval_step(pc)["loss"])
    # over a distributed mesh the step would be graphed on a card but is not
    real = graphs.use_graph
    monkeypatch.setattr("diffuscene_tpu_torch.train.trainer.use_graph",
                        lambda graph, device, noise_fn=None, uncapturable=None:
                        real(graph, torch.device("cuda"), noise_fn, uncapturable))
    scene = SceneDiffusion(_configs("float32")[1], bounds=BOUNDS, device="cpu")
    mesh = Mesh(1, 1, distributed=True)
    assert not Trainer(scene, _training(FLAGSHIP), device="cpu", mesh=mesh).graph
    assert Trainer(scene, _training(FLAGSHIP), device="cpu").graph
