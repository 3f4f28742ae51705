"""One rank of the port's two-rank CPU checks (gloo), for
tests/test_torch_parallel*.py.  It imports the port only: the parent test
runs the JAX references and passes inputs and results through files.

    python tests/_torch_parallel_child.py CHECK WORKDIR RANK WORLD PORT

reads WORKDIR/inputs.pt, writes WORKDIR/CHECK_RANK.pt and destroys its
process group.  CHECK is one of:

- ``scene``: two steps of the scene Trainer on a (2 data x 1 model) mesh
  and on a (1 data x 2 model) mesh with tensor parallelism, from the given
  weights, batches, t and noise; one data-parallel step whose t and noise
  the trainer draws; the gathered parameters, EMA and state_dict;
- ``sampler``: ShardedSampler over 2 data ranks for every task family and
  ``fused`` setting, and the per-process helpers of parallel/distributed.py;
- ``ae``: one AETrainer step on a (2 data x 1 model) mesh.
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

BOUNDS = {"translations_min": np.array([-2.7, 0.0, -2.7], np.float32),
          "translations_max": np.array([2.7, 3.6, 2.7], np.float32),
          "sizes_min": np.array([0.04, 0.03, 0.05], np.float32),
          "sizes_max": np.array([1.8, 1.7, 1.9], np.float32)}
SCENE_B, N_OBJ = 8, 12
TRAIN_CFG = {"optimizer": "Adam", "lr": 1e-4, "schedule": "step", "lr_step": 1000,
             "lr_decay": 0.5, "max_grad_norm": 10.0, "ema_decay": 0.5}
SAMPLER_FAMILIES = ("uncond", "dpm", "text", "complete", "arrange")
SAMPLER_FUSED = {"plain": False, "3d": True, "rows": "rows"}
SAMPLER_SEED = 7
AE_B, AE_POINTS, AE_LAT = 8, 128, 32
AE_TRAIN_CFG = {"optimizer": "Adam", "lr": 1e-4, "schedule": "step", "lr_step": 400,
                "lr_decay": 0.1, "max_grad_norm": 10.0, "weight_decay": 0.0}


def scene_kwargs(kind):
    """SceneModelConfig kwargs (the same for both packages): ``train``, the
    tensor-parallel test's model (dim 64, 2 levels, v-prediction, the IoU
    loss); ``uncond``, ``text`` and ``arrange``, the sharded-sampler
    test's models (dim 32)."""
    nk = dict(dim=64 if kind == "train" else 32, dim_mults=(1, 1), channels=62,
              objectness_dim=0, class_dim=22, angle_dim=2, objfeat_dim=32, context_dim=0,
              instanclass_dim=16, seperate_all=True)
    kw = dict(point_dim=62, class_dim=22, angle_dim=2, objectness_dim=0, objfeat_dim=32,
              sample_num_points=N_OBJ, room_mask_condition=False, instance_condition=True,
              learnable_embedding=True, instance_emb_dim=16, model_mean_type="v",
              time_num=8 if kind == "train" else 6)
    if kind == "train":
        kw.update(loss_separate=True, loss_iou=True)
    if kind == "text":
        nk.update(text_condition=True, text_dim=32)
        kw.update(text_condition=True, text_glove_embedding=True, text_embed_dim=32)
    if kind == "arrange":
        nk.update(channels=5, seperate_all=False, out_dim=5, instanclass_dim=16 + 8)
        kw.update(room_arrange_condition=True, arrange_emb_dim=8)
    return dict(kw, net_kwargs=tuple(sorted(nk.items())))


def sampler_scene(kind):
    """A sampler test model on the CPU with weights from seed 0."""
    from diffuscene_tpu_torch.models import SceneDiffusion, SceneModelConfig

    scene = SceneDiffusion(SceneModelConfig(**scene_kwargs(kind)), device="cpu")
    return scene.init(torch.Generator().manual_seed(0))


def sampler_inputs():
    """The conditioning of each family, made from a numpy seed (B=8)."""
    rng = np.random.default_rng(3)
    return {"text_emb": rng.normal(0, 1, (SCENE_B, 10, 50)).astype(np.float32),
            "partial_boxes": rng.uniform(-1, 1, (SCENE_B, 4, 62)).astype(np.float32),
            "input_boxes": rng.uniform(-1, 1, (SCENE_B, N_OBJ, 62)).astype(np.float32)}


def family_call(family, inputs):
    """(model kind, SceneDiffusion.sample / ShardedSampler kwargs, sampler
    options) of a task family."""
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    return {"uncond": ("uncond", {}, {}),
            "dpm": ("uncond", {}, {"dpm": True, "dpm_steps": 3}),
            "text": ("text", {"text_emb": t["text_emb"]}, {}),
            "complete": ("uncond", {"partial_boxes": t["partial_boxes"]}, {}),
            "arrange": ("arrange", {"input_boxes": t["input_boxes"]}, {})}[family]


def _scene_check(inp, rank):
    from diffuscene_tpu_torch.models import SceneDiffusion, SceneModelConfig
    from diffuscene_tpu_torch.parallel import make_mesh
    from diffuscene_tpu_torch.train.trainer import Trainer

    def trainer(mesh, tp=False):
        scene = SceneDiffusion(SceneModelConfig(**scene_kwargs("train")), bounds=BOUNDS,
                               device="cpu")
        tr = Trainer(scene, TRAIN_CFG, steps_per_epoch=50, device="cpu", mesh=mesh,
                     tensor_parallel=tp)
        tr.set_weights(inp["state"])
        return tr

    out = {}
    for label, shape, tp in (("dp", (2, 1), False), ("tp", (1, 2), True)):
        tr = trainer(make_mesh(*shape), tp)
        metrics = []
        for b, t, noise in zip(inp["batches"], inp["t"], inp["noise"]):
            metrics.append(tr.train_step(tr.put_batch(b), t=torch.from_numpy(t).long(),
                                         noise=torch.from_numpy(noise)))
        state = tr.state_dict()
        out[label] = {"metrics": metrics, "model": state["model"], "ema": state["ema"],
                      "slots": state["optimizer"]["slots"], "n_sharded": len(tr._sharded),
                      "local_numel": sum(p.numel() for p in tr.params)}
    mesh = make_mesh(2, 1)
    tr = trainer(mesh)
    tr.generator.manual_seed(5)
    out["drawn"] = tr.train_step(tr.put_batch(inp["batches"][0]))
    return out


def _sampler_check(inp, rank):
    from diffuscene_tpu_torch.parallel import (ShardedSampler, global_batch_from_host_local,
                                               host_local_slice, make_mesh,
                                               shard_indices_for_host)

    mesh = make_mesh()
    rows = host_local_slice(SCENE_B)
    out = {"helpers": {"slice": (rows.start, rows.stop),
                       "indices": shard_indices_for_host(np.arange(11)).tolist(),
                       "gathered": global_batch_from_host_local(
                           torch.arange(SCENE_B)[rows].float(), mesh)}}
    for family in SAMPLER_FAMILIES:
        kind, cond, opts = family_call(family, inp["sampler"])
        scene = sampler_scene(kind)
        for label, fused in SAMPLER_FUSED.items():
            sampler = ShardedSampler(scene, mesh, fused=fused, **opts).put_params()
            gen = torch.Generator().manual_seed(SAMPLER_SEED)
            out[(family, label)] = sampler.sample(SCENE_B, gen, **cond)
    return out


def _ae_check(inp, rank):
    from diffuscene_tpu_torch.models.autoencoder import KLAutoEncoder
    from diffuscene_tpu_torch.parallel import make_mesh
    from diffuscene_tpu_torch.train import AETrainer

    model = KLAutoEncoder(latent_dim=AE_LAT, kl_weight=0.001, device="cpu")
    model.load_state_dict(inp["ae_state"])
    trainer = AETrainer(model, AE_TRAIN_CFG, steps_per_epoch=500, device="cpu",
                        mesh=make_mesh(2, 1))
    m = trainer.train_step(trainer.put_batch(inp["pc"]), eps=torch.from_numpy(inp["eps"]))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return {"metrics": m, "state": {k: v.clone() for k, v in model.state_dict().items()},
            "local_grads": grads}


CHECKS = {"scene": _scene_check, "sampler": _sampler_check, "ae": _ae_check}


def main():
    check, workdir, rank, world, port = sys.argv[1:6]
    rank, world = int(rank), int(world)
    os.nice(5)
    torch.set_num_threads(1)
    from threadpoolctl import threadpool_limits

    import torch.distributed as dist

    from diffuscene_tpu_torch.parallel import initialize

    with threadpool_limits(1):
        got = initialize(backend="gloo", device="cpu", init_method=f"tcp://127.0.0.1:{port}",
                         world_size=world, rank=rank, timeout_s=100)
        assert got == (rank, world), got
        try:
            inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
            out = CHECKS[check](inp, rank)
            torch.save(out, os.path.join(workdir, f"{check}_{rank}.pt"))
        finally:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()


class TwoRanks:
    """The parent's side: write the inputs, start the ranks of ``check``
    (each on one thread, at a lower priority, nice 5: the suite's longest
    file runs beside the two-rank files and keeps its cores), and later
    :meth:`results`, which waits at most ``timeout`` seconds in all, kills
    the ranks on a timeout, and returns each rank's outputs or raises with
    their errors."""

    def __init__(self, check, workdir, inputs, world=2, timeout=120.0):
        import socket
        import subprocess
        import time

        self.check, self.workdir, self.world = check, str(workdir), world
        self.deadline = time.monotonic() + timeout
        torch.save(inputs, os.path.join(self.workdir, "inputs.pt"))
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                   OPENBLAS_NUM_THREADS="1")
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), check, self.workdir, str(r), str(world),
             str(port)], cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(world)]
        self._out = None

    def results(self):
        import subprocess
        import time

        if self._out is None:
            errors = []
            for r, p in enumerate(self.procs):
                try:
                    _, err = p.communicate(timeout=max(self.deadline - time.monotonic(), 1.0))
                except subprocess.TimeoutExpired:
                    for q in self.procs:
                        q.kill()
                    _, err = p.communicate()
                    errors.append(f"rank {r} timed out\n{err[-3000:]}")
                    continue
                if p.returncode != 0:
                    errors.append(f"rank {r} exited {p.returncode}\n{err[-3000:]}")
            self._out = errors or [
                torch.load(os.path.join(self.workdir, f"{self.check}_{r}.pt"), weights_only=False)
                for r in range(self.world)]
        if isinstance(self._out[0], str):
            raise AssertionError("\n".join(self._out))
        return self._out
