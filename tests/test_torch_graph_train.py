"""The port's train steps as bodies over device buffers, run from a CUDA
graph on the card (diffuscene_tpu_torch/train/trainer.py,
train/ae_trainer.py, utils/graphs.py): the counterpart of the JAX package's
jitted ``Trainer.train_step`` and ``train_step_scan`` (a ``lax.scan``) and
``AETrainer.train_step``.

The eager steps are held against the JAX package in
tests/test_torch_train.py, test_torch_train_steps.py,
test_torch_train_b512.py, test_torch_mixed_precision.py,
test_torch_optim_extras.py, test_torch_room_mask_model.py and
test_torch_autoencoder.py.  Here the graph path is held against the eager
step, at dim 64 (the room-mask model at its test's dim 32, two scenes a
batch, 32x32 masks; the AE on two clouds of 64 points):

- each step body driven through the graph path with an eager stand-in
  for the capture (each replay runs the body and copies its outputs into
  static tensors, as a replay overwrites a graph's outputs) equals the
  eager ``train_step`` of a twin trainer from the same seed bit for bit:
  parameters, EMA, optimizer moments and count, the accumulator, BatchNorm
  moments, the generator's state and every step's metrics;
- ``train_step_scan`` over k=3 batches from the graph path equals three
  eager ``train_step`` calls (the metrics are their mean, summed in f32 on
  the device: within 1e-6 relative);
- ``graph=`` selection and refusals;
- the chamfer kernel's launches under a simulated capture (``torch.cuda``
  stubbed): 2 a step, counted at every replay.
"""
import contextlib
import os
import weakref

import numpy as np
import pytest
import torch

from diffuscene_tpu_torch.models import SceneDiffusion, SceneModelConfig
from diffuscene_tpu_torch.models.autoencoder import KLAutoEncoder
from diffuscene_tpu_torch.ops import build, chamfer
from diffuscene_tpu_torch.parallel import Mesh
from diffuscene_tpu_torch.train import ae_trainer as ae_mod
from diffuscene_tpu_torch.train import trainer as trainer_mod
from diffuscene_tpu_torch.train.ae_trainer import AETrainer
from diffuscene_tpu_torch.train.trainer import Trainer
from diffuscene_tpu_torch.utils import graphs
from diffuscene_tpu_torch.utils.config import load_config
from test_torch_losses import BOUNDS, _configs, _scene_batch
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = "configs/uncond/diffusion_bedrooms_instancond_lat32_v.yaml"
B512 = "configs/uncond/diffusion_bedrooms_instancond_lat32_v_b512_tpu.yaml"
B = 4
AE_B, AE_POINTS = 2, 64


def _training(path, **over):
    return {**load_config(os.path.join(REPO, path))["training"], "ema_decay": 0.5, **over}


def _room_mask_config():
    """tests/test_torch_room_mask.py's room-mask model (dim 32, a ResNet18
    over the masks)."""
    nk = dict(dim=32, dim_mults=(1, 1), channels=62, objectness_dim=0, class_dim=22,
              angle_dim=2, objfeat_dim=32, context_dim=64, instanclass_dim=16, seperate_all=True)
    return SceneModelConfig(
        point_dim=62, class_dim=22, angle_dim=2, objectness_dim=0, objfeat_dim=32,
        sample_num_points=12, room_mask_condition=True, latent_dim=64, instance_condition=True,
        learnable_embedding=True, instance_emb_dim=16, model_mean_type="v",
        model_var_type="fixedsmall", time_num=10, loss_separate=True, loss_iou=False,
        net_kwargs=tuple(sorted(nk.items())))


def _masks(rng, batch, size=32):
    """Room masks, (batch, 1, size, size): a filled rectangle a scene (at
    32x32, a quarter of the extractor's work at the configs' 64x64: it
    pools adaptively)."""
    out = np.zeros((batch, 1, size, size), np.float32)
    for m in out:
        y0, x0 = rng.integers(1, size // 3, 2)
        y1, x1 = rng.integers(2 * size // 3, size - 1, 2)
        m[0, y0:y1, x0:x1] = 1.0
    return out


# case -> (scene config, training block, Trainer keyword arguments, the
# steps: (batch size, whether t and noise are given) each)
SCENE_CASES = {
    # grad_accum 2: a micro-step and a micro-step with the update, each with
    # drawn and given t and noise, and a batch of another shape
    "f32_accum2": (lambda: _configs("float32")[1], _training(FLAGSHIP, grad_accum=2), {},
                   [(B, False)] * 4 + [(B, True)] * 4 + [(3, False)] * 2),
    # the b512 recipe (fused Adam, bf16 moments, gradients and EMA) under
    # mixed precision (bf16 copies through functional_call)
    "b512_mixed_precision": (lambda: _configs("bfloat16")[1], _training(B512),
                             {"mixed_precision": True}, [(B, False)] * 4),
    # RAdam's ro crosses its threshold at the 6th step
    "radam": (lambda: _configs("float32")[1], _training(FLAGSHIP, optimizer="RAdam"), {},
              [(B, False)] * 7),
    # a warm step and a replay: the extractor's 11M parameters make the
    # optimizer most of a step's time on the CPU
    "room_mask": (_room_mask_config, _training(FLAGSHIP), {}, [(2, False)] * 2),
}


class _EagerStepGraph:
    """The capture stood in for on the CPU: each replay runs the step
    eagerly and copies what it returns into static outputs."""

    replays = 0

    def __init__(self, step, device, generator, stream=None):
        self.step, self.capture_s, self.outputs = step, 0.0, None

    def replay(self):
        _EagerStepGraph.replays += 1
        out = self.step()
        if self.outputs is None:
            self.outputs = graphs._clone(out)
        else:
            graphs._copy(self.outputs, out)

    def close(self):
        pass


def _stand_in(monkeypatch):
    """The trainers' graph path on the CPU, through the eager stand-in."""
    monkeypatch.setattr(graphs, "StepGraph", _EagerStepGraph)
    monkeypatch.setattr(graphs, "on_side_stream", lambda fn, device: (fn(), None))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    for mod in (trainer_mod, ae_mod):
        monkeypatch.setattr(mod, "use_graph",
                            lambda graph, device, noise_fn=None, uncapturable=None: bool(graph))
    _EagerStepGraph.replays = 0


def _scene_inputs(case, steps, seed=5):
    """Host batches, t and noise of each step, made from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for batch, given in steps:
        host = _scene_batch(rng, batch=batch, n=12)
        if case == "room_mask":
            host["room_layout"] = _masks(rng, batch)
        t = torch.from_numpy(rng.integers(0, 10, batch)) if given else None
        noise = torch.from_numpy(rng.normal(size=(batch, 12, 62)).astype(np.float32)) \
            if given else None
        out.append((host, t, noise))
    return out


def _scene_trainer(case, graph):
    cfg, training, kw, _ = SCENE_CASES[case]
    bounds = None if case == "room_mask" else BOUNDS
    scene = SceneDiffusion(cfg(), bounds=bounds, device="cpu")
    return Trainer(scene, training, steps_per_epoch=3, device="cpu", graph=graph, **kw).init(3)


def _scene_state(tr):
    return ([p.detach() for p in tr.params] + [tr._ema, tr.opt._moments, tr.acc]
            + [b for b in tr.scene.networks.buffers()] + [tr.generator.get_state()],
            (tr.step, tr.mini_step, tr.opt.count))


def _ae_state(tr):
    return ([p.detach() for p in tr.model.parameters()] + list(tr.model.buffers())
            + [tr.opt._moments, tr.generator.get_state()], tr.opt.count)


def _equal(a, b):
    (ta, ha), (tb, hb) = a, b
    assert ha == hb
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize("case", list(SCENE_CASES) + ["ae"])
def test_graphed_step_body_is_the_eager_step(case, monkeypatch):
    """The graph path (a warm step, then the captured body replayed, one
    variant per batch shape, per given or drawn t and noise and per
    grad_accum micro-step kind) through the eager stand-in equals the eager
    train_step bit for bit, every step's metrics included, and replays
    every variant called more than once."""
    if case == "ae":
        rng = np.random.default_rng(6)
        steps = [(rng.uniform(-0.5, 0.5, (AE_B, AE_POINTS, 3)).astype(np.float32),
                  rng.standard_normal((AE_B, 32)).astype(np.float32) if i >= 2 else None)
                 for i in range(4)]

        def run(graph):
            model = KLAutoEncoder(latent_dim=32, device="cpu")
            tr = AETrainer(model, _training(FLAGSHIP), steps_per_epoch=3, device="cpu",
                           graph=graph).init(4)
            ms = [tr.train_step(tr.put_batch(pc), None if eps is None else torch.from_numpy(eps))
                  for pc, eps in steps]
            return ms, _ae_state(tr)
    else:
        inputs = _scene_inputs(case, SCENE_CASES[case][3])

        def run(graph):
            tr = _scene_trainer(case, graph)
            ms = [tr.train_step(tr.put_batch(host), t, noise) for host, t, noise in inputs]
            return ms, _scene_state(tr)

    eager_metrics, eager_state = run(False)
    _stand_in(monkeypatch)
    graph_metrics, graph_state = run(True)
    assert graph_metrics == eager_metrics
    _equal(graph_state, eager_state)
    assert _EagerStepGraph.replays > 0


def test_train_step_scan_from_a_graph_is_three_steps(monkeypatch):
    """train_step_scan over k=3 stacked batches, the step from the graph
    path with t and noise drawn by the registered generator, equals three
    eager train_step calls; its metrics are theirs averaged (summed on the
    device: within 1e-6 relative).  The trainer's graphs go with it."""
    hosts = [h for h, _, _ in _scene_inputs("f32", [(B, False)] * 3, seed=7)]
    seq = _scene_trainer("radam", False)
    ms = [seq.train_step(seq.put_batch(h)) for h in hosts]
    _stand_in(monkeypatch)
    scan = _scene_trainer("radam", True)
    got = scan.train_step_scan(scan.put_batches(hosts))
    _equal(_scene_state(scan), _scene_state(seq))
    assert _EagerStepGraph.replays == 2        # a warm step, then a replay a step
    for k, v in got.items():
        np.testing.assert_allclose(v, np.mean([m[k] for m in ms]), rtol=1e-6)
    # the graphs hold their trainer weakly: dropping it frees them
    dropped = weakref.ref(scan)
    del scan
    assert dropped() is None


def test_graph_selection_and_refusals():
    """graph=None: a graph on a CUDA device, the eager step on the CPU and
    over a distributed mesh; graph=True raises on the CPU and over a
    distributed mesh, in both trainers."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert graphs.use_graph(None, cuda) and not graphs.use_graph(None, cpu)
    assert not graphs.use_graph(None, cuda, uncapturable="over a distributed mesh")
    with pytest.raises(ValueError, match="distributed mesh"):
        graphs.use_graph(True, cuda, uncapturable="over a distributed mesh")
    with pytest.raises(ValueError, match="CUDA"):
        _scene_trainer("f32_accum2", True)
    model = KLAutoEncoder(latent_dim=32, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        AETrainer(model, _training(FLAGSHIP), device="cpu", graph=True)
    mesh = Mesh(1, 1, distributed=True)
    scene = SceneDiffusion(_configs("float32")[1], bounds=BOUNDS, device="cpu")
    with pytest.raises(ValueError, match="distributed mesh"):
        Trainer(scene, _training(FLAGSHIP), device="cpu", mesh=mesh, graph=True)
    with pytest.raises(ValueError, match="distributed mesh"):
        AETrainer(model, _training(FLAGSHIP), device="cpu", mesh=mesh, graph=True)
    assert not Trainer(scene, _training(FLAGSHIP), device="cpu", mesh=mesh).graph
    tr = _scene_trainer("f32_accum2", None)
    host, _, _ = _scene_inputs("f32", [(B, False)])[0]
    tr.train_step(tr.put_batch(host))
    assert not tr.graph and tr.step_graphs.costs == [] and tr.step == 1


class _FakeGraph:
    """torch.cuda.CUDAGraph stood in for: a replay runs nothing."""

    def register_generator_state(self, generator):
        pass

    def replay(self):
        pass

    def reset(self):
        pass


def test_chamfer_launches_under_a_simulated_capture(monkeypatch):
    """An AE trainer's graph path with torch.cuda stubbed so that the
    capture runs on the CPU (the current stream reads as capturing inside
    torch.cuda.graph) and each chamfer direction counting as a launch: the
    warm step counts its 2, the capture tallies 2 and counts none, and each
    replay (one a step from the second on) adds 2: n steps count 2n; no
    prepared operand is made."""
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
    pc = tr.put_batch(np.random.default_rng(8).uniform(-0.5, 0.5, (AE_B, AE_POINTS, 3)))
    counts = []
    for _ in range(3):
        m = tr.train_step(pc)
        counts.append(chamfer.directed_nn.launches)
    assert counts == [2, 4, 6] and np.isfinite(m["loss"])
    # the capture's call counted nothing itself: its replay added the tally
    (step,) = tr.step_graphs._steps.values()
    assert dict(step[1].graph.tally) == {(chamfer.directed_nn, None): 2}
    assert build.prepared.made == made
