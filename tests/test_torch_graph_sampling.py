"""The port's sampling loops as step bodies over device tables
(diffuscene_tpu_torch/diffusion/samplers.py), the step-replay driver that
runs them from a CUDA graph on the card, and the kernel launch counters
under capture and replay (ops/build.py).

- Each loop's body against the JAX package's ``lax.scan`` loop
  (diffuscene_tpu/diffusion/samplers.py) with one small denoiser written
  in both frameworks (a tanh of a dense map of x plus a timestep
  embedding), the JAX noise stream replayed: atol 1e-4, the samplers'
  tolerance of tests/test_torch_sampling.py (f32 math summed in another
  order); the bound sweep rtol 1e-5, tests/test_torch_tasks.py's (its t=0
  term divides by the clipped posterior variance, so its values are huge).
- The driver's graph path, with an eager stand-in for the capture, against
  the eager loop from the same generator: bit for bit.
- The counters under a simulated capture (``torch.cuda`` stubs): a
  DDPM-1000 whose step launches what the 3-D engine's forward launches
  counts exactly 28,000 B1 and 1,000 B2, the rows engine's 19,000 B4.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuscene_tpu.diffusion import make_schedule as j_make_schedule
from diffuscene_tpu.diffusion import samplers as js
from diffuscene_tpu_torch.diffusion import make_schedule
from diffuscene_tpu_torch.diffusion import samplers as ts
from diffuscene_tpu_torch.ops import attention, build, fused_level, fused_resblock
from diffuscene_tpu_torch.utils import graphs
from test_torch_tasks import _complete_stream, _replay
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


B, N, D, P, T = 3, 5, 4, 2, 10
TOL = {"bpd": dict(rtol=1e-5)}
rng = np.random.default_rng(0)
W = (rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32)
EMB = rng.normal(size=(T, D)).astype(np.float32)
X0 = rng.normal(size=(B, N, D)).clip(-1, 1).astype(np.float32)
PARTIAL = rng.normal(size=(B, P, D)).clip(-1, 1).astype(np.float32)


def j_denoise(x, t):
    return jnp.tanh(x @ W + jnp.asarray(EMB)[t][:, None, :])


def t_denoise(x, t):
    return torch.tanh(x @ torch.from_numpy(W) + torch.from_numpy(EMB)[t][:, None, :])


def _stream(key, shape, n_draws, x_t=True):
    """The JAX loops' draws: x_T from the first split (unless ``x_t`` is
    False, as in calc_bpd_loop), then one split a drawing step."""
    k, out = key, []
    if x_t:
        k, init_key = jax.random.split(k)
        out.append(np.asarray(jax.random.normal(init_key, shape, jnp.float32)))
    for _ in range(n_draws):
        k, sub = jax.random.split(k)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return out


# (loop, JAX call, port call, the JAX noise stream); mean type v, fixedsmall
CASES = {
    "ddpm": (lambda s, k: js.p_sample_loop(s, "v", "fixedsmall", j_denoise, (B, N, D), k),
             lambda s, nf: ts.p_sample_loop(s, "v", "fixedsmall", t_denoise, (B, N, D),
                                            noise_fn=nf),
             lambda k: _stream(k, (B, N, D), T)),
    "trajectory": (lambda s, k: js.p_sample_loop_trajectory(s, "v", "fixedsmall", j_denoise,
                                                            (B, N, D), k, freq=2),
                   lambda s, nf: ts.p_sample_loop_trajectory(s, "v", "fixedsmall", t_denoise,
                                                             (B, N, D), 2, noise_fn=nf),
                   lambda k: _stream(k, (B, N, D), T)),
    "complete": (lambda s, k: js.p_sample_loop_complete(s, "v", "fixedsmall", j_denoise,
                                                        (B, N, D), k, jnp.asarray(PARTIAL)),
                 lambda s, nf: ts.p_sample_loop_complete(s, "v", "fixedsmall", t_denoise,
                                                         (B, N, D), torch.from_numpy(PARTIAL),
                                                         noise_fn=nf),
                 lambda k: _complete_stream(k, (B, N, D), (B, P, D), T)),
    "arrange": (lambda s, k: js.p_sample_loop_arrange(s, "v", "fixedsmall", j_denoise,
                                                      (B, N, 9), k, 3, 1),
                lambda s, nf: ts.p_sample_loop_arrange(s, "v", "fixedsmall", t_denoise,
                                                       (B, N, 9), 3, 1, noise_fn=nf),
                lambda k: _stream(k, (B, N, D), T)),
    "ddim_eta0": (lambda s, k: js.ddim_sample_loop(s, "v", j_denoise, (B, N, D), k, 4, 0.0),
                  lambda s, nf: ts.ddim_sample_loop(s, "v", t_denoise, (B, N, D), 4, 0.0,
                                                    noise_fn=nf),
                  lambda k: _stream(k, (B, N, D), 4)),
    "ddim_eta05": (lambda s, k: js.ddim_sample_loop(s, "v", j_denoise, (B, N, D), k, 4, 0.5),
                   lambda s, nf: ts.ddim_sample_loop(s, "v", t_denoise, (B, N, D), 4, 0.5,
                                                     noise_fn=nf),
                   lambda k: _stream(k, (B, N, D), 4)),
    "dpm": (lambda s, k: js.dpm_solver_sample_loop(s, "v", j_denoise, (B, N, D), k, 6),
            lambda s, nf: ts.dpm_solver_sample_loop(s, "v", t_denoise, (B, N, D), 6,
                                                    noise_fn=nf),
            lambda k: _stream(k, (B, N, D), 0)),
    # 16 steps over 10 timesteps: duplicate integer timesteps, h == 0
    "dpm_duplicates": (lambda s, k: js.dpm_solver_sample_loop(s, "v", j_denoise, (B, N, D), k,
                                                              16),
                       lambda s, nf: ts.dpm_solver_sample_loop(s, "v", t_denoise, (B, N, D),
                                                               16, noise_fn=nf),
                       lambda k: _stream(k, (B, N, D), 0)),
    "bpd": (lambda s, k: js.calc_bpd_loop(s, "v", "fixedsmall", j_denoise, jnp.asarray(X0), k),
            lambda s, nf: ts.calc_bpd_loop(s, "v", "fixedsmall", t_denoise, torch.from_numpy(X0),
                                           noise_fn=nf),
            lambda k: _stream(k, (B, N, D), T, x_t=False)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_loops_match_the_jax_scans(case):
    """Each loop's step body (its timestep and coefficient tables read at
    the step counter) against the JAX scan from the same noise: within
    TOL, every draw of the stream used."""
    j_call, t_call, stream = CASES[case]
    if case == "arrange":    # the arrange loop draws on its (B, N, 4) sub-shape
        stream = lambda k: _stream(k, (B, N, 4), T)  # noqa: E731
    key = jax.random.PRNGKey(3)
    want = jax.tree.map(np.asarray, jax.jit(lambda k: j_call(j_make_schedule(
        "linear", 1e-4, 0.02, T, "v"), k))(key))
    noises = stream(key)
    got = t_call(make_schedule("linear", 1e-4, 0.02, T, "v", device="cpu"), _replay(noises))
    assert not noises
    got = [g.numpy() for g in got] if isinstance(got, tuple) else [got.numpy()]
    want = list(want) if isinstance(want, tuple) else [want]
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **TOL.get(case, dict(atol=1e-4, rtol=0)))
    if case == "complete":
        assert np.array_equal(got[0][:, :P], PARTIAL)


class _EagerStepGraph:
    """The driver's capture, stood in for on the CPU: each replay runs the
    step eagerly."""

    replays = 0

    def __init__(self, step, device, generator, stream=None):
        self.step, self.capture_s, self.outputs = step, 0.0, None

    def replay(self):
        _EagerStepGraph.replays += 1
        self.step()

    def close(self):
        pass


@pytest.mark.parametrize("case", ["ddpm", "trajectory", "complete", "ddim_eta05",
                                  "dpm_duplicates", "bpd"])
def test_step_replay_driver_is_the_eager_loop(case, monkeypatch):
    """The graph path of run_steps (a warm step, then n - 1 replays of the
    captured step), with the capture replaced by an eager stand-in on the
    CPU, equals the eager loop (graph=False) from the same generator bit
    for bit, and replays every step after the first."""
    sched = make_schedule("linear", 1e-4, 0.02, T, "v", device="cpu")

    def sample(graph):
        gen = torch.Generator().manual_seed(9)
        call = {"ddpm": lambda: ts.p_sample_loop(sched, "v", "fixedsmall", t_denoise,
                                                 (B, N, D), gen, graph=graph),
                "trajectory": lambda: ts.p_sample_loop_trajectory(
                    sched, "v", "fixedsmall", t_denoise, (B, N, D), 2, gen, graph=graph),
                "complete": lambda: ts.p_sample_loop_complete(
                    sched, "v", "fixedsmall", t_denoise, (B, N, D), torch.from_numpy(PARTIAL),
                    gen, graph=graph),
                "ddim_eta05": lambda: ts.ddim_sample_loop(sched, "v", t_denoise, (B, N, D), 4,
                                                          0.5, generator=gen, graph=graph),
                "dpm_duplicates": lambda: ts.dpm_solver_sample_loop(
                    sched, "v", t_denoise, (B, N, D), 16, generator=gen, graph=graph),
                "bpd": lambda: ts.calc_bpd_loop(sched, "v", "fixedsmall", t_denoise,
                                                torch.from_numpy(X0), gen, graph=graph)}[case]
        out = call()
        return out if isinstance(out, tuple) else (out,)

    eager = sample(False)
    monkeypatch.setattr(graphs, "StepGraph", _EagerStepGraph)
    monkeypatch.setattr(graphs, "on_side_stream", lambda fn, device: (fn(), None))
    monkeypatch.setattr(ts, "use_graph", lambda graph, device, noise_fn=None: bool(graph))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    _EagerStepGraph.replays = 0
    replayed = sample(True)
    steps = {"ddim_eta05": 4, "dpm_duplicates": 16}.get(case, T)
    assert _EagerStepGraph.replays == steps - 1
    assert ts.run_steps.last["replays"] == steps - 1
    for a, b in zip(eager, replayed, strict=True):
        assert torch.equal(a, b)


def test_graph_selection_and_refusals():
    """graph=None: a graph on a CUDA device, eager on the CPU or with a
    noise_fn; graph=True raises on CPU tensors and beside a noise_fn."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert ts.use_graph(None, cuda) and not ts.use_graph(None, cpu)
    assert not ts.use_graph(None, cuda, noise_fn=np.zeros) and not ts.use_graph(False, cuda)
    assert ts.use_graph(True, cuda)
    with pytest.raises(ValueError, match="CUDA"):
        ts.use_graph(True, cpu)
    with pytest.raises(ValueError, match="noise_fn"):
        ts.use_graph(True, cuda, noise_fn=np.zeros)
    sched = make_schedule("linear", 1e-4, 0.02, T, "v", device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ts.p_sample_loop(sched, "v", "fixedsmall", t_denoise, (B, N, D),
                         torch.Generator(), graph=True)
    with pytest.raises(ValueError, match="noise_fn"):
        ts.dpm_solver_sample_loop(sched, "v", t_denoise, (B, N, D), 4,
                                  noise_fn=lambda s: torch.zeros(s), graph=True)


class _FakeGraph:
    """torch.cuda.CUDAGraph stood in for: a replay runs nothing."""

    def register_generator_state(self, generator):
        pass

    def replay(self):
        pass

    def reset(self):
        pass


def _simulated_capture(monkeypatch):
    """Stub torch.cuda so run_steps' graph path runs on the CPU: inside
    ``torch.cuda.graph`` the current stream reads as capturing, and the
    warm step runs on the current stream."""
    capturing = [False]

    @contextlib.contextmanager
    def graph(g, stream=None):
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


def test_launch_counts_under_capture_and_replay(monkeypatch):
    """A 1000-step loop whose step launches a 3-D forward's kernels (28 B1,
    1 B2) counts exactly 28,000 and 1,000 (by kernel too): the eager warm
    step counts its own, the capture tallies instead of counting and each
    replay adds the tally; a rows forward's 19 B4, 19,000.  A launch
    captured outside build.launch_tally raises, and so does a capture that
    makes a prepared operand."""
    _simulated_capture(monkeypatch)
    rb, at, fl = fused_resblock.fused_resnet_block, attention.fused_set_attention, \
        fused_level.apply_chain
    for c in (rb, at, fl):
        monkeypatch.setattr(c, "launches", 0)
        monkeypatch.setattr(c, "by_kernel", {})

    def forward_3d(i):
        for k in range(28):
            build.count_launch(rb, "resblock_tf32" if k % 2 else "resblock_tf32_wide")
        build.count_launch(at, "attention_tf32")

    ts.run_steps(forward_3d, 1000, torch.device("cpu"), graph=True)
    assert (rb.launches, at.launches) == (28_000, 1_000)
    assert rb.by_kernel == {"resblock_tf32": 14_000, "resblock_tf32_wide": 14_000}
    assert at.by_kernel == {"attention_tf32": 1_000} and fl.launches == 0
    ts.run_steps(lambda i: [build.count_launch(fl, "chain_tf32") for _ in range(19)], 1000,
                 torch.device("cpu"), graph=True)
    assert fl.launches == 19_000 and fl.by_kernel == {"chain_tf32": 19_000}
    assert rb.launches == 28_000
    with pytest.raises(RuntimeError, match="launch_tally"):
        with torch.cuda.graph(None):
            build.count_launch(rb, "resblock_tf32")

    def makes_an_operand(i):
        if torch.cuda.is_current_stream_capturing():
            build.prepared(torch.zeros(1), (), lambda: None)

    with pytest.raises(RuntimeError, match="prepared"):
        ts.run_steps(makes_an_operand, 3, torch.device("cpu"), graph=True)
