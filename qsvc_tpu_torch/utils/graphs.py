"""Device programs captured as CUDA graphs once per static key and
replayed per call: the port's counterpart of ``jax.jit`` on fixed shapes.

``captured(fn)`` returns a function with ``fn``'s signature.  Its key is
``fn`` and every argument, flattened through tuples, lists and
NamedTuples (``MCTFStream``, ``LevelData``, lists of motion fields): a
tensor leaf gives its shape, dtype and device, any other leaf its value,
which must hash (ints, bools, strings, the frozen ``CodecConfig``), as
``jax.jit``'s static arguments do.

- **CPU tensors** (or no tensor at all): ``fn`` runs eagerly, as
  ``jax.jit`` compiles for the CPU.  Nothing else happens.
- **CUDA tensors**, first call of a key: the arguments are copied into
  static input buffers; ``fn`` runs eagerly on them on a side stream (the
  warm-up: ``nvcc`` builds ``csrc/`` at first use, K1 raises its shared
  memory limit once, the libraries set up their workspaces, none of which
  may happen inside a capture); then ``fn`` is captured into a
  ``torch.cuda.CUDAGraph`` that reads the static inputs.
- **CUDA tensors, every call** (the first included): copy the arguments
  into the static inputs, replay, and copy every output into a new
  tensor the caller owns.  A result never aliases the graph's buffers,
  which the next replay overwrites (``api.compress_chunks`` holds GOP g's
  results while GOP g+1 replays the same graph).

A failed warm-up, capture or replay raises with CUDA's error; nothing
falls back to the eager result.  The eager functions stay public under
their own names.

Threads: capture and copy-in/replay/copy-out run under one lock per
device (``api.expand_gops`` decodes in two threads), and captures use
``capture_error_mode="thread_local"``, so another thread's eager work
during a capture is legal.  Calls on different streams are ordered by an
event recorded after each call's copy-out.

Tracing: under a ``utils.trace`` run log every call is the device span
``graph.<fn name>`` (copy-in, replay and copy-out on the card; the eager
run on the CPU), and a capture the host span ``graphs.capture``.  The
program spans that ``fn`` opens (``trace.program_span``) are captured as
stamps into the graph, log or no log; a replay under a log that keeps
them copies the graph's stamps out after its outputs, and the log places
them inside the replay's device span.  A program that opens none (the
whole-pixel MCTF, every texture program) is captured as it was.

Launches: ``ops.cuda_lib.launches`` counts kernel launches.  A capture
launches nothing, so the wrappers' counts during a capture go to the
graph's own record and each replay adds that record: the counter keeps
counting kernels that ran (the warm-up's are real runs and count too).

Memory policy: the graphs of one device share one memory pool and at
most :data:`MAX_GRAPHS` of them are kept, least recently used first out;
an evicted graph frees its graph and its static buffers.  Sharing the
pool is safe here because a replay's outputs are copied out before the
lock is released and every later replay is ordered after that copy, so
a graph only ever overwrites another's intermediates and static outputs
once they are dead.  The pool then holds about the largest working set
of one program (several GB for a sub-pixel a = 3 GOP), not the sum over
keys.  :func:`clear` drops every graph; ``torch.cuda.empty_cache()``
then returns the pool's memory.
"""

from __future__ import annotations

import collections
import functools
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch

from ..ops import cuda_lib
from . import trace

#: graphs kept per device (the flagship encode and decode use about 13)
MAX_GRAPHS = 32


def _flatten(tree, leaves: List[Any]):
    """Append the leaves of ``tree`` to ``leaves``; return its structure
    (hashable: container types and lengths, leaves as None)."""
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_flatten(t, leaves) for t in tree))
    leaves.append(tree)
    return None


def _unflatten(spec, leaves):
    """Inverse of :func:`_flatten` over an iterator of leaves."""
    if spec is None:
        return next(leaves)
    kind, children = spec
    items = [_unflatten(c, leaves) for c in children]
    if kind is list:
        return items
    if kind is tuple:
        return tuple(items)
    return kind(*items)                    # a NamedTuple


def _tree(args: tuple, kwargs: dict) -> tuple:
    """The arguments of a call as one tree (keywords sorted by name)."""
    return (tuple(args), tuple(sorted(kwargs.items())))


def _key(fn: Callable, spec, leaves: List[Any]) -> Tuple:
    sig = tuple(("tensor", tuple(x.shape), x.dtype, x.device)
                if isinstance(x, torch.Tensor) else x for x in leaves)
    return (fn, spec, sig)


def graph_key(fn: Callable, *args, **kwargs) -> Tuple:
    """The static key of the call ``fn(*args, **kwargs)``: ``fn``, the
    structure of its arguments, each tensor's (shape, dtype, device) and
    every other leaf's value."""
    leaves: List[Any] = []
    spec = _flatten(_tree(args, kwargs), leaves)
    return _key(fn, spec, leaves)


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: List[torch.Tensor]         # static inputs, in leaf order
    out_spec: Any
    outputs: List[Any]                 # static outputs (and other leaves)
    launches: collections.Counter      # kernel launches of one replay
    stats: Dict[str, Any]
    stamps: Any                        # trace.GraphStamps, or None


class _Device:
    """The graphs of one device, its lock, pool, capture stream and the
    event recorded after the last call's copy-out."""

    def __init__(self, index: int):
        self.index = index
        self.lock = threading.Lock()
        self.graphs: "collections.OrderedDict[Tuple, _Graph]" = \
            collections.OrderedDict()
        self.pool = None
        self.stream = None
        self.done = None


_devices: Dict[int, _Device] = {}
_devices_lock = threading.Lock()


def _device(index: int) -> _Device:
    with _devices_lock:
        return _devices.setdefault(index, _Device(index))


def _capture(fn, leaves: List[Any], spec, dev: _Device) -> _Graph:
    """Static inputs (copies of the tensor leaves), the warm-up, the
    capture."""
    t0 = time.perf_counter()
    inputs = [x.detach().clone(memory_format=torch.contiguous_format)
              for x in leaves if isinstance(x, torch.Tensor)]

    def call():
        it = iter(inputs)
        args, kwargs = _unflatten(spec, iter(
            [next(it) if isinstance(x, torch.Tensor) else x
             for x in leaves]))
        return fn(*args, **dict(kwargs))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), trace.capturing(
            trace.GraphStamps(cuda_lib.stamp)):
        call()          # the warm-up; its program spans' stamps are dropped
    torch.cuda.current_stream().wait_stream(side)
    t1 = time.perf_counter()
    if not dev.graphs:
        # a fresh pool: the last one went with its last graph
        dev.pool = torch.cuda.graph_pool_handle()
    if dev.stream is None:
        dev.stream = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    launches: collections.Counter = collections.Counter()
    stamps = trace.GraphStamps(cuda_lib.stamp)
    with cuda_lib.counting_into(launches), trace.capturing(stamps), \
            torch.cuda.graph(graph, pool=dev.pool, stream=dev.stream,
                             capture_error_mode="thread_local"):
        out = call()
    out_leaves: List[Any] = []
    out_spec = _flatten(out, out_leaves)
    stats = dict(name=fn.__qualname__, device=dev.index,
                 shapes=[tuple(x.shape) for x in inputs],
                 warmup_s=t1 - t0, capture_s=time.perf_counter() - t1,
                 replays=0)
    return _Graph(graph, inputs, out_spec, out_leaves, launches, stats,
                  stamps if stamps.sites else None)


def _run(fn: Callable, leaves: List[Any], spec):
    """One call of the captured ``fn`` on its flattened arguments: eager
    without a CUDA tensor, else the replay of its key's graph (captured
    first if the key is new)."""
    name = "graph." + fn.__name__
    devices = {x.device for x in leaves if isinstance(x, torch.Tensor)}
    if not any(d.type == "cuda" for d in devices):
        args, kwargs = _unflatten(spec, iter(leaves))
        with trace.device_stage(name, "cpu"):
            return fn(*args, **dict(kwargs))
    if len(devices) > 1:
        raise ValueError(f"{fn.__qualname__}: tensors on "
                         f"{sorted(map(str, devices))}; a captured "
                         f"program takes one device")
    device = devices.pop()
    key = _key(fn, spec, leaves)
    dev = _device(device.index)
    with torch.cuda.device(device), dev.lock:
        stream = torch.cuda.current_stream()
        if dev.done is not None:
            stream.wait_event(dev.done)
        entry = dev.graphs.get(key)
        fresh = entry is None
        if fresh:
            with trace.stage("graphs.capture", program=fn.__name__):
                entry = _capture(fn, leaves, spec, dev)
            dev.graphs[key] = entry
            while len(dev.graphs) > MAX_GRAPHS:
                if dev.done is not None:
                    dev.done.synchronize()     # no replay still reads it
                dev.graphs.popitem(last=False)
        else:
            dev.graphs.move_to_end(key)
        # everything the copies need is allocated first: inside the
        # device span the host only queues the copy-in, the replay and the
        # copy-out, so that no allocation or collection lands between
        # them while the card waits
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        outs = [x for x in entry.outputs if isinstance(x, torch.Tensor)]
        copies = [torch.empty_like(x) for x in outs]
        stamps = trace.replay_stamps(entry.stamps, name, device)
        with trace.device_stage(name, device, stamps=stamps):
            if stamps is not None:
                stamps.begin()
            if not fresh:       # a capture copied its inputs already
                torch._foreach_copy_(entry.inputs, tensors)
            entry.graph.replay()
            torch._foreach_copy_(copies, outs)
            if stamps is not None:
                stamps.end()
        it = iter(copies)
        out = [next(it) if isinstance(x, torch.Tensor) else x
               for x in entry.outputs]
        cuda_lib.launches.update(entry.launches)
        entry.stats["replays"] += 1
        dev.done = torch.cuda.Event()
        dev.done.record(stream)
    return _unflatten(entry.out_spec, iter(out))


def captured(fn: Callable) -> Callable:
    """``fn`` as a captured program (see the module docstring)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        leaves: List[Any] = []
        spec = _flatten(_tree(args, kwargs), leaves)
        return _run(fn, leaves, spec)
    return wrapper


def stats() -> List[Dict[str, Any]]:
    """One dict per kept graph, oldest first on each device: fn name,
    device, static input shapes, warm-up and capture seconds, kernel
    launches per replay and replays so far."""
    with _devices_lock:
        devices = list(_devices.values())
    out = []
    for dev in devices:
        with dev.lock:
            out += [dict(e.stats, launches=dict(e.launches))
                    for e in dev.graphs.values()]
    return out


def clear() -> None:
    """Drop every kept graph of every device."""
    with _devices_lock:
        devices = list(_devices.values())
    for dev in devices:
        with dev.lock:
            if dev.done is not None:
                dev.done.synchronize()
            dev.graphs.clear()
