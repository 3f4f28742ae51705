"""CUDA graphs of step bodies: the machinery that the samplers and the
trainers share.

A step body is a function over device tensors that keeps its state in
buffers it updates in place, reads every per-step value from a device
tensor that the host writes before the step, and keeps no host state, so
that the same body runs eagerly (on the CPU, and on the card with
``graph=False``) or from a CUDA graph: captured once and replayed, which is
what the JAX package's ``jax.jit`` / ``lax.scan`` compile the step into.

- :func:`use_graph` resolves a caller's ``graph=None|False|True``.
- :class:`StepGraph` captures one step on a side stream, with a
  ``torch.Generator`` registered so that its draws inside the graph follow
  the eager step's, and the kernel launches of the capture tallied
  (``ops/build.py:launch_tally``): each replay adds them to the wrappers'
  counters.  A capture that makes a prepared kernel operand raises.
- :class:`GraphedStep` runs a step body from a graph, one call a step (a
  sampler's loop, ``diffusion/samplers.py:run_steps``, and a trainer's
  steps): its first call eagerly on a side stream (the warm step: it
  builds the kernels, fills their prepared operands and creates the
  libraries' handles and workspaces for that stream), its second captures
  the body on that stream, and every call from the second on replays the
  graph.
- :class:`GraphedSteps` keeps one :class:`GraphedStep` per shape of the
  inputs, with static copies of the inputs that each call copies the
  caller's tensors into: a batch of another shape captures another graph,
  as ``jax.jit`` retraces.

A failed capture raises; nothing falls back to the eager step.
"""
from __future__ import annotations

import gc
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..ops import build


def use_graph(graph: Optional[bool], device: torch.device, noise_fn: Optional[Callable] = None,
              uncapturable: Optional[str] = None) -> bool:
    """Whether a step on ``device`` runs from a CUDA graph: ``None`` picks the
    graph on a CUDA device and the eager step elsewhere, with a ``noise_fn``
    (a sampler's host call a step) or where ``uncapturable`` says why the
    step cannot be captured; ``True`` raises in each of those cases."""
    if graph is None:
        return device.type == "cuda" and noise_fn is None and uncapturable is None
    if graph and noise_fn is not None:
        raise ValueError("graph=True draws from a generator inside the graph; noise_fn is a "
                         "host call a step: pass graph=None or False with it")
    if graph and uncapturable is not None:
        raise ValueError(f"graph=True cannot capture this step: {uncapturable}; pass graph=None "
                         f"or False")
    if graph and device.type != "cuda":
        raise ValueError(f"graph=True needs CUDA tensors; the step's are on {device}")
    return bool(graph)


class StepGraph:
    """One step captured into a CUDA graph, on ``stream`` (else the capture's
    own side stream): ``generator`` is registered with the graph, the kernel
    launches of the capture are tallied (``build.launch_tally``) and each
    :meth:`replay` adds them to the wrappers' counters.  ``outputs`` is
    what the step returned during the capture: static tensors that every
    replay overwrites.  A capture that made a prepared kernel operand raises
    (``build.prepared.made`` moved: it would live in the graph's memory and
    be made again at every replay), as does any failure of the capture.
    :meth:`close` frees the graph and its memory pool.  ``capture_s`` is
    the capture's and the instantiation's seconds."""

    def __init__(self, step: Callable[[], Any], device: torch.device,
                 generator: Optional[torch.Generator], stream=None):
        made = build.prepared.made
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        self.outputs = None
        try:
            if generator is not None:
                self.graph.register_generator_state(generator)
            # torch.cuda.graph collects garbage before the capture; none
            # during it: a graph freed by the collector resets itself, which
            # a capture does not permit
            enabled = gc.isenabled()
            gc.disable()
            try:
                with build.launch_tally() as self.tally:
                    with torch.cuda.graph(self.graph, stream=stream):
                        self.outputs = step()
            finally:
                if enabled:
                    gc.enable()
            torch.cuda.synchronize(device)
            if build.prepared.made != made:
                raise RuntimeError(f"capturing a step made {build.prepared.made - made} prepared "
                                   f"kernel operands that the eager step did not")
        except BaseException:
            self.close()
            raise
        self.capture_s = time.perf_counter() - t0

    def replay(self) -> None:
        self.graph.replay()
        build.add_tally(self.tally)

    def close(self) -> None:
        self.outputs = None
        self.graph.reset()


def on_side_stream(fn: Callable[[], Any], device: torch.device) -> Tuple[Any, Any]:
    """``fn()`` on a new side stream, after the work queued on the current
    stream and before what is queued on it next: (what ``fn`` returned, the
    stream)."""
    stream = torch.cuda.Stream(device)
    current = torch.cuda.current_stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = fn()
    current.wait_stream(stream)
    return out, stream


class GraphedStep:
    """``body`` run from a CUDA graph, one call a step: the first call runs
    it eagerly on a side stream (the warm step), the second captures it on
    that stream (:class:`StepGraph`, ``generator`` registered) and replays
    the graph, and every later call replays it.  Returns what ``body``
    returns: the eager result on the first call, the graph's static outputs
    after (overwritten by the next replay).  ``warm_s`` and ``capture_s``
    are the warm step's (ending in a synchronize) and the capture's
    seconds; :meth:`close` frees the graph."""

    def __init__(self, body: Callable[[], Any], device: torch.device,
                 generator: Optional[torch.Generator]):
        self.body, self.device, self.generator = body, device, generator
        self.stream = None
        self.graph: Optional[StepGraph] = None
        self.warm_s: Optional[float] = None
        self.capture_s: Optional[float] = None

    def __call__(self) -> Any:
        if self.warm_s is None:
            t0 = time.perf_counter()
            out, self.stream = on_side_stream(self.body, self.device)
            torch.cuda.synchronize(self.device)
            self.warm_s = time.perf_counter() - t0
            return out
        if self.graph is None:
            self.graph = StepGraph(self.body, self.device, self.generator, self.stream)
            self.capture_s = self.graph.capture_s
        self.graph.replay()
        return self.graph.outputs

    def close(self) -> None:
        if self.graph is not None:
            self.graph.close()
            self.graph = None


def _signature(x) -> Any:
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype, x.device
    if isinstance(x, tuple):
        return tuple(_signature(v) for v in x)
    return tuple((k, _signature(v)) for k, v in sorted(x.items()))


def _clone(x):
    if x is None or isinstance(x, torch.Tensor):
        return None if x is None else x.clone()
    return {k: _clone(v) for k, v in x.items()}


def _copy(static, x) -> None:
    if isinstance(static, torch.Tensor):
        static.copy_(x)
    elif static is not None:
        for k, v in static.items():
            _copy(v, x[k])


class GraphedSteps:
    """The captured variants of a step body: ``steps(body, *inputs,
    key=...)`` copies ``inputs`` (tensors, dicts of tensors, or None) into
    the static copies of the variant their shapes, dtypes and ``key``
    select (made at the variant's first call, which runs ``body`` eagerly)
    and runs ``body(*static copies)`` through the variant's
    :class:`GraphedStep`.  ``body`` must be the same function for the same
    ``key``, and hold its owner (the object that keeps this) by a weak
    reference: a cycle would keep the graphs and their memory after the
    owner is dropped, until the garbage collector runs.  :meth:`close`
    frees every graph (a caller that rebinds a buffer the bodies hold must
    call it); ``costs`` gives each variant's key, warm and capture
    seconds."""

    def __init__(self, device: torch.device, generator: Optional[torch.Generator]):
        self.device, self.generator = device, generator
        self._steps: Dict[Any, Tuple[tuple, GraphedStep]] = {}

    def __call__(self, body: Callable[..., Any], *inputs, key: Any = None) -> Any:
        sig = (key, _signature(inputs))
        hit = self._steps.get(sig)
        if hit is None:
            static = tuple(_clone(x) for x in inputs)
            hit = self._steps[sig] = (static, GraphedStep(lambda: body(*static), self.device,
                                                          self.generator))
        else:
            for s, x in zip(hit[0], inputs):
                _copy(s, x)
        return hit[1]()

    @property
    def costs(self) -> List[Tuple[Any, Optional[float], Optional[float]]]:
        return [(sig[0], step.warm_s, step.capture_s) for sig, (_, step) in self._steps.items()]

    def close(self) -> None:
        for _, step in self._steps.values():
            step.close()
        self._steps.clear()
