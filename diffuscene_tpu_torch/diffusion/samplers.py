"""Sampling loops: DDPM ancestral sampling (with its trajectory, scene
completion and re-arrangement variants), DDIM, DPM-Solver++(2M) and the
variational-bound sweep.

Port of ``diffuscene_tpu/diffusion/samplers.py``, whose loops are
``lax.scan``s compiled to one XLA program.  Here every loop is one step
body over device tensors, run by :func:`run_steps`:

- the state the loop carries (x; DPM-Solver++'s previous x0; a
  trajectory's frames; the bound sweep's terms) lives in buffers that the
  body updates in place;
- every per-step value lives in a table on the device, read at a step
  counter that the body is given and that :func:`run_steps` advances on
  the device: the timesteps, DDIM's sqrt(a_next), c and sigma,
  DPM-Solver++'s sigma ratio, its a_n (e^{-h} - 1) and its two D weights
  (1 and 0 on a first-order step), the frame each trajectory step writes.
  The tables are made on the host in f32 up front, so a step sends no
  value back from the card.

The same body runs eagerly (on the CPU, and on the card with
``graph=False``) or from a CUDA graph (``graph=None``, the default, on a
CUDA device): the first step runs eagerly on a side stream, which builds
the kernels and fills their prepared-operand caches, then one step is
captured on that stream and
replayed for the rest (:func:`run_steps`, on ``utils/graphs.py``'s
:class:`GraphedStep` and :func:`use_graph`, which the trainers share).  A
graph and an eager loop of the same seed give the same sample.  Under a
graph the kernel wrappers' launch counters count what the card runs
(``ops/build.py:count_launch``).

Randomness comes from an explicit ``torch.Generator`` (drawn inside the
step, in the order below, so a graph's replays draw what the eager loop
draws; the graph registers the generator), or from ``noise_fn(shape) ->
tensor`` so a test can replay another framework's noise stream (a host
call a step: the loop then runs eagerly, and ``graph=True`` beside it
raises).  ``shard=(index, count)`` draws for ``count`` times the batch and
keeps the index-th block of rows, so a data rank's sample does not depend
on the split.  Each loop draws in the order of the JAX sampler's key
splits:

- DDPM (``p_sample_loop``, ``p_sample_loop_trajectory`` and
  ``p_sample_loop_arrange``, the last on the (B, N, translation_dim +
  angle_dim) sub-shape): x_T, then one tensor per step (the t == 0 draw is
  masked out);
- completion (``p_sample_loop_complete``): x_T, then per step the partial
  boxes' noise at (B, P, D) first and the step noise at (B, N, D) second
  (the JAX body's ``split(k, 3)``: k_noise, then k_step);
- DDIM: x_T, then one tensor per step (even at eta 0);
- DPM-Solver++: x_T only;
- the bound sweep (``calc_bpd_loop``): no x_T, one tensor per step.

``denoise_fn(x, t) -> model_output`` closes over the network and the
per-scene conditioning; under a graph it must keep no host state across
calls.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..utils.graphs import GraphedStep, use_graph
from .gaussian import model_predictions, p_mean_variance, prior_bpd, q_sample, vb_terms_bpd
from .schedule import DiffusionSchedule

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
NoiseFn = Callable[[Tuple[int, ...]], torch.Tensor]
Shard = Tuple[int, int]


def p_sample_step(
    sched: DiffusionSchedule,
    model_mean_type: str,
    model_var_type: str,
    denoise_fn: DenoiseFn,
    x: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
    clip_denoised: bool,
) -> torch.Tensor:
    """One ancestral DDPM step with the given standard-normal ``noise``.
    (diffusion_ddpm.py:339-352)"""
    model_output = denoise_fn(x, t)
    model_mean, model_log_variance, _ = p_mean_variance(
        sched, model_mean_type, model_var_type, model_output, x, t, clip_denoised
    )
    nonzero_mask = (t > 0).to(x.dtype).reshape(-1, *([1] * (x.ndim - 1)))
    return model_mean + nonzero_mask * torch.exp(0.5 * model_log_variance) * noise


def run_steps(body: Callable[[torch.Tensor], None], n: int, device: torch.device,
              graph: bool, generator: Optional[torch.Generator] = None) -> None:
    """Run ``body(i)`` for the steps 0 .. n-1, ``i`` a (1,) int64 step counter
    on ``device`` that is advanced on the device after each step.  Eagerly,
    or with ``graph`` from a CUDA graph (:class:`GraphedStep`): the first
    step eagerly on a side stream (it builds the kernels, fills the
    prepared operands and warms the libraries), then the step captured once
    and replayed n - 1 times.  A failed capture or replay raises; the graph
    and its memory are freed before this returns.  ``run_steps.last`` holds
    the last graph's costs: the warm step's and the capture's seconds, the
    replays' (the calls after the warm step to a synchronize, less the
    capture's), and the number of replays."""
    i = torch.zeros(1, dtype=torch.long, device=device)

    def step():
        body(i)
        i.add_(1)

    if not graph or n < 2:
        for _ in range(n):
            step()
        return
    graphed = GraphedStep(step, device, generator)
    try:
        graphed()
        t0 = time.perf_counter()
        for _ in range(n - 1):
            graphed()
        torch.cuda.synchronize(device)
        after_warm_s = time.perf_counter() - t0
    finally:
        graphed.close()
    run_steps.last = {"warm_s": graphed.warm_s, "capture_s": graphed.capture_s, "replays": n - 1,
                      "replay_s": after_warm_s - graphed.capture_s}


run_steps.last = None


class _Loop:
    """What every loop shares: the noise source, the device, the graph
    choice and the timestep table read at the step counter."""

    def __init__(self, sched: DiffusionSchedule, batch: int, times,
                 generator: Optional[torch.Generator], noise_fn: Optional[NoiseFn],
                 graph: Optional[bool], shard: Shard):
        if (generator is None) == (noise_fn is None):
            raise ValueError("pass exactly one of generator and noise_fn")
        self.device = sched.betas.device
        self.graph = use_graph(graph, self.device, noise_fn)
        self.generator, self.noise_fn, self.shard = generator, noise_fn, shard
        # (steps, B): the step counter's row is the step's t, as a contiguous (B,)
        self.t_tab = self.table(times, torch.long)[:, None].repeat(1, batch)

    def table(self, values, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(values, dtype=dtype).to(self.device)

    def t(self, i: torch.Tensor) -> torch.Tensor:
        return self.t_tab.index_select(0, i)[0]

    def at(self, tab: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        return tab.index_select(0, i)

    def draw(self, shape) -> torch.Tensor:
        """A standard-normal f32 tensor of ``shape`` on the schedule's device."""
        if self.noise_fn is not None:
            return self.noise_fn(tuple(shape)).to(device=self.device, dtype=torch.float32)
        index, count = self.shard
        b = shape[0]
        full = torch.randn((b * count, *shape[1:]), generator=self.generator,
                           device=self.device, dtype=torch.float32)
        return full if count == 1 else full[index * b:(index + 1) * b]

    def run(self, body: Callable[[torch.Tensor], None], n: int) -> None:
        run_steps(body, n, self.device, self.graph, self.generator)


def _ddpm_times(sched: DiffusionSchedule) -> List[int]:
    return list(range(sched.num_timesteps - 1, -1, -1))


def p_sample_loop(
    sched: DiffusionSchedule,
    model_mean_type: str,
    model_var_type: str,
    denoise_fn: DenoiseFn,
    shape: Tuple[int, ...],
    generator: Optional[torch.Generator] = None,
    clip_denoised: bool = True,
    noise_fn: Optional[NoiseFn] = None,
    graph: Optional[bool] = None,
    shard: Shard = (0, 1),
) -> torch.Tensor:
    """Full T-step DDPM ancestral sampling.  (diffusion_ddpm.py:355-371)

    Exactly one of ``generator`` (draws on its device) and ``noise_fn``
    must be given; ``graph`` and ``shard`` as the module docstring says."""
    times = _ddpm_times(sched)
    loop = _Loop(sched, shape[0], times, generator, noise_fn, graph, shard)
    x = loop.draw(shape)

    def body(i):
        x.copy_(p_sample_step(sched, model_mean_type, model_var_type, denoise_fn,
                              x, loop.t(i), loop.draw(shape), clip_denoised))

    loop.run(body, len(times))
    return x


def p_sample_loop_trajectory(
    sched: DiffusionSchedule,
    model_mean_type: str,
    model_var_type: str,
    denoise_fn: DenoiseFn,
    shape: Tuple[int, ...],
    freq: int,
    generator: Optional[torch.Generator] = None,
    clip_denoised: bool = True,
    noise_fn: Optional[NoiseFn] = None,
    graph: Optional[bool] = None,
    shard: Shard = (0, 1),
) -> torch.Tensor:
    """DDPM sampling that also returns frames (diffusion_ddpm.py:373-398):
    x_T, then x after every step whose t == T - 1 or t % freq == 0, stacked
    -> (n_frames, *shape); (1 + T) frames for freq == 1, 2 + T // freq for
    a freq > 1 that divides T.  Every step writes x into the frame of the
    next emitting step (its own, if it emits), which that step overwrites."""
    times = _ddpm_times(sched)
    T = sched.num_timesteps
    emits = [t == T - 1 or t % freq == 0 for t in times]
    slot, frame = [], 1 + sum(emits)
    for e in reversed(emits):       # the frame each step writes: its next emitting step's
        frame -= e
        slot.append(frame)
    slot.reverse()
    loop = _Loop(sched, shape[0], times, generator, noise_fn, graph, shard)
    x = loop.draw(shape)
    frames = x.new_empty((1 + sum(emits), *shape))
    frames[0] = x
    slot_tab = loop.table(slot, torch.long)

    def body(i):
        x.copy_(p_sample_step(sched, model_mean_type, model_var_type, denoise_fn,
                              x, loop.t(i), loop.draw(shape), clip_denoised))
        frames.index_copy_(0, loop.at(slot_tab, i), x[None])

    loop.run(body, len(times))
    return frames


def p_sample_loop_complete(
    sched: DiffusionSchedule,
    model_mean_type: str,
    model_var_type: str,
    denoise_fn: DenoiseFn,
    shape: Tuple[int, ...],
    partial_boxes: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    clip_denoised: bool = True,
    noise_fn: Optional[NoiseFn] = None,
    graph: Optional[bool] = None,
    shard: Shard = (0, 1),
) -> torch.Tensor:
    """RePaint-style scene completion (diffusion_ddpm.py:447-476): before
    every reverse step the first P slots are overwritten with
    ``q_sample(partial_boxes, t, noise)``; after the last step the clean
    ``partial_boxes`` (B, P, D) are spliced in, bit for bit."""
    times = _ddpm_times(sched)
    loop = _Loop(sched, shape[0], times, generator, noise_fn, graph, shard)
    P = partial_boxes.shape[1]
    x = loop.draw(shape)

    def body(i):
        t = loop.t(i)
        partial_t = q_sample(sched, partial_boxes, t, loop.draw(partial_boxes.shape))
        x_in = torch.cat([partial_t, x[:, P:]], dim=1)
        x.copy_(p_sample_step(sched, model_mean_type, model_var_type, denoise_fn,
                              x_in, t, loop.draw(shape), clip_denoised))

    loop.run(body, len(times))
    return torch.cat([partial_boxes, x[:, P:]], dim=1)


def p_sample_loop_arrange(
    sched: DiffusionSchedule,
    model_mean_type: str,
    model_var_type: str,
    denoise_fn: DenoiseFn,
    shape: Tuple[int, ...],
    translation_dim: int,
    angle_dim: int,
    generator: Optional[torch.Generator] = None,
    clip_denoised: bool = True,
    noise_fn: Optional[NoiseFn] = None,
    graph: Optional[bool] = None,
    shard: Shard = (0, 1),
) -> torch.Tensor:
    """Re-arrangement (diffusion_ddpm.py:478-506): DDPM on the (translation,
    angle) channels only.  ``shape`` is the full (B, N, point_dim) scene
    shape; the result is (B, N, translation_dim + angle_dim), which the
    caller splices into the conditioning boxes."""
    return p_sample_loop(sched, model_mean_type, model_var_type, denoise_fn,
                         (shape[0], shape[1], translation_dim + angle_dim),
                         generator=generator, clip_denoised=clip_denoised, noise_fn=noise_fn,
                         graph=graph, shard=shard)


def calc_bpd_loop(
    sched: DiffusionSchedule,
    model_mean_type: str,
    model_var_type: str,
    denoise_fn: DenoiseFn,
    x_start: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    clip_denoised: bool = True,
    noise_fn: Optional[NoiseFn] = None,
    graph: Optional[bool] = None,
):
    """The variational bound in bits/dim over every timestep, t = T-1 down
    to 0 (reference calc_bpd_loop, diffusion_ddpm.py:690-717) -> the means
    of (total bpd, the vb terms, the prior bpd, the x_0 MSE)."""
    times = _ddpm_times(sched)
    B = x_start.shape[0]
    loop = _Loop(sched, B, times, generator, noise_fn, graph, (0, 1))
    vals_bt = x_start.new_empty((len(times), B))     # (T, B) each
    mse_bt = x_start.new_empty((len(times), B))

    def body(i):
        t = loop.t(i)
        data_t = q_sample(sched, x_start, t, loop.draw(x_start.shape))
        vb, pred_xstart = vb_terms_bpd(sched, model_mean_type, model_var_type,
                                       denoise_fn(data_t, t), x_start, data_t, t, clip_denoised)
        vals_bt.index_copy_(0, i, vb[None])
        mse_bt.index_copy_(0, i, ((pred_xstart - x_start) ** 2).reshape(B, -1).mean(dim=-1)[None])

    loop.run(body, len(times))
    prior = prior_bpd(sched, x_start)
    total = vals_bt.sum(dim=0) + prior
    return total.mean(), vals_bt.mean(), prior.mean(), mse_bt.mean()


def _time_pairs(num_timesteps: int, steps: int) -> List[Tuple[int, int]]:
    """(time, time_next) pairs walking linspace(-1, T-1, steps+1) in
    reverse, truncated to int32 as the JAX samplers do; the last time_next
    is -1."""
    times = np.linspace(-1, num_timesteps - 1, num=steps + 1).astype(np.int32).tolist()
    times = times[::-1]
    return list(zip(times[:-1], times[1:]))


def _alphas_cumprod_ext(sched: DiffusionSchedule) -> torch.Tensor:
    """alphas_cumprod on the host with a 1.0 appended, so index -1 (the final
    time_next) reads alpha_bar = 1."""
    acp = sched.alphas_cumprod.detach().to("cpu", torch.float32)
    return torch.cat([acp, torch.ones(1)])


def ddim_sample_loop(
    sched: DiffusionSchedule,
    model_mean_type: str,
    denoise_fn: DenoiseFn,
    shape: Tuple[int, ...],
    sampling_timesteps: int = 50,
    eta: float = 0.0,
    clip_denoised: bool = True,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[NoiseFn] = None,
    graph: Optional[bool] = None,
    shard: Shard = (0, 1),
) -> torch.Tensor:
    """DDIM over a strided timestep subsequence (the JAX package's corrected
    version of reference ddim_sample_loop, diffusion_ddpm.py:401-444):

        x <- x0 sqrt(a_next) + c eps + sigma z,   c = sqrt(max(1 - a_next - sigma^2, 0))

    with sigma = eta sqrt((1 - a/a_next)(1 - a_next)/(1 - a)); the last step
    returns x0 exactly."""
    pairs = _time_pairs(sched.num_timesteps, sampling_timesteps)
    acp = _alphas_cumprod_ext(sched)
    sqrt_next, c_tab, sigma_tab = [], [], []
    for time, time_next in pairs:
        alpha, alpha_next = acp[time], acp[time_next]
        sigma = eta * torch.sqrt((1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))
        sqrt_next.append(torch.sqrt(alpha_next))
        c_tab.append(torch.sqrt(torch.clamp(1 - alpha_next - sigma ** 2, min=0.0)))
        sigma_tab.append(sigma)
    loop = _Loop(sched, shape[0], [p[0] for p in pairs], generator, noise_fn, graph, shard)
    sqrt_next, c_tab, sigma_tab = (loop.table(torch.stack(v)) for v in (sqrt_next, c_tab,
                                                                         sigma_tab))
    final = loop.table([time_next < 0 for _, time_next in pairs], torch.bool)
    x = loop.draw(shape)

    def body(i):
        t = loop.t(i)
        pred_noise, x_start = model_predictions(
            sched, model_mean_type, denoise_fn(x, t), x, t, clip_x_start=clip_denoised)
        noise = loop.draw(shape)
        x_next = (x_start * loop.at(sqrt_next, i) + loop.at(c_tab, i) * pred_noise
                  + loop.at(sigma_tab, i) * noise)
        x.copy_(torch.where(loop.at(final, i), x_start, x_next))

    loop.run(body, len(pairs))
    return x


def dpm_solver_sample_loop(
    sched: DiffusionSchedule,
    model_mean_type: str,
    denoise_fn: DenoiseFn,
    shape: Tuple[int, ...],
    sampling_timesteps: int = 20,
    clip_denoised: bool = True,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[NoiseFn] = None,
    graph: Optional[bool] = None,
    shard: Shard = (0, 1),
) -> torch.Tensor:
    """DPM-Solver++(2M) (Lu et al., arXiv 2211.01095) in data-prediction
    form, with sigma_t = sqrt(1 - alpha_bar_t), a_t = sqrt(alpha_bar_t),
    lambda_t = log(a_t / sigma_t):

        x_{i+1} = (sigma_{i+1}/sigma_i) x_i - a_{i+1} (e^{-h_i} - 1) D_i
        D_i     = (1 + 1/(2 r_i)) x0_i - 1/(2 r_i) x0_{i-1}

    with h_i = lambda_{i+1} - lambda_i, r_i = h_{i-1}/h_i, and e^{-h} as the
    ratio (a_i sigma_{i+1})/(a_{i+1} sigma_i), exactly 0 at the final
    boundary.  First order (D = x0: weights 1 and 0) on the first step, at
    the final boundary and where h or h_prev is 0 (duplicate integer
    timesteps)."""
    pairs = _time_pairs(sched.num_timesteps, sampling_timesteps)
    acp = _alphas_cumprod_ext(sched)
    a_all = torch.sqrt(acp)
    sig_all = torch.sqrt(torch.clamp(1.0 - acp, min=1e-20))
    lam_all = torch.log(a_all) - torch.log(sig_all)
    ratio, coef, w_now, w_prev = [], [], [], []
    h_prev = torch.ones(())
    for step, (time, time_next) in enumerate(pairs):
        a_i, a_n = a_all[time], a_all[time_next]
        s_i, s_n = sig_all[time], sig_all[time_next]
        h = lam_all[time_next] - lam_all[time]
        if step == 0 or time_next < 0 or h.item() == 0.0 or h_prev.item() == 0.0:
            w_now.append(torch.ones(()))
            w_prev.append(torch.zeros(()))
        else:
            c2 = 1.0 / (2.0 * (h_prev / h))
            w_now.append(1.0 + c2)
            w_prev.append(c2)
        exp_mh = (a_i * s_n) / (a_n * s_i)
        ratio.append(s_n / s_i)
        coef.append(a_n * (exp_mh - 1.0))
        h_prev = h
    loop = _Loop(sched, shape[0], [p[0] for p in pairs], generator, noise_fn, graph, shard)
    ratio, coef, w_now, w_prev = (loop.table(torch.stack(v)) for v in (ratio, coef, w_now,
                                                                      w_prev))
    x = loop.draw(shape)
    x0_prev = torch.zeros_like(x)

    def body(i):
        t = loop.t(i)
        _, x0 = model_predictions(sched, model_mean_type, denoise_fn(x, t), x, t,
                                  clip_x_start=clip_denoised)
        d = loop.at(w_now, i) * x0 - loop.at(w_prev, i) * x0_prev
        x.copy_(loop.at(ratio, i) * x - loop.at(coef, i) * d)
        x0_prev.copy_(x0)

    loop.run(body, len(pairs))
    return x
