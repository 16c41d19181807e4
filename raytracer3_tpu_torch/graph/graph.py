"""Declarative frame graph (port of ``raytracer3_tpu/graph/graph.py``):
passes declare the named resources they read and write; the graph derives
the execution order once and returns a step function called per frame.

The shape is the reference render graph's (``src/renderer/render_graph/``):
named transient resources, pass builders with read/write declarations, a
DFS bake from the pass that writes the output (unreachable passes are
culled), and the builder's construction-time assertions (duplicate pass
names, a resource declared twice by one pass, a read that no pass writes,
two writers of one resource). Barriers and layout tracking have no
counterpart: the passes run in order on one stream.

Temporal state is a ping-pong resource: a pass reads ``name@prev`` and
writes ``name``; the step returns the new state dict, which the caller
feeds back. Each pass body runs inside the span ``pass:<name>``
(``utils/profiling.span``), so a profile of an eager step names the passes.
On a CUDA device the step also launches a marker kernel before each pass of
the baked order and one after the last (``pass_mark_kernel<I>``,
``ops/traverse_kernel.pass_mark``): I is the boundary's place in
``step.pass_order``, so a device trace of a replayed graph, whose host
ranges do not run, still divides its kernels by pass.

``compile(jit=True)`` (the default, as in the reference) runs the step on a
CUDA device as one CUDA graph (``capture_step``): the counterpart of the
reference's ``jax.jit``. The first call of each signature runs the step
eagerly once and captures it; later calls copy their inputs into the
graph's static buffers and replay it. With ``donate_state=True`` the state
the step returns is those buffers, as a donated JAX state is reused. The
call into the device (the replay with its input copies and output clones,
or the eager run where no tensor is on a CUDA device) is the span
``graph:run``.
"""

from __future__ import annotations

import dataclasses
import inspect
import itertools
from typing import Any, Callable, Dict, List, Sequence

import torch
from torch.utils import _pytree as pytree

from raytracer3_tpu_torch.utils import profiling


class GraphError(RuntimeError):
    pass


@dataclasses.dataclass
class _Pass:
    name: str
    fn: Callable[..., Dict[str, Any]]
    reads: tuple[str, ...]
    writes: tuple[str, ...]


@dataclasses.dataclass
class _Resource:
    name: str
    shape: tuple
    dtype: torch.dtype
    temporal: bool  # has a @prev ping-pong slot


class FrameGraph:
    """Build once, compile once, call per frame.

    Example::

        g = FrameGraph()
        g.image("depth", (H, W))
        g.temporal("light", (H, W, 3))            # has light@prev
        g.add_pass("gbuffer", fn, writes=["depth"])
        g.add_pass("shade", fn2, reads=["depth", "light@prev"], writes=["light"])
        step = g.compile(output="light")
        state = g.init_state(device)
        out, state = step(state, camera=cam, frame_index=0)
    """

    def __init__(self):
        self._resources: Dict[str, _Resource] = {}
        self._passes: List[_Pass] = []
        self._pass_names = set()

    def _declare(self, name: str, shape: Sequence[int], dtype, temporal: bool) -> str:
        if name in self._resources:
            raise GraphError(f"duplicate resource {name!r}")
        self._resources[name] = _Resource(name, tuple(shape), dtype, temporal)
        return name

    def image(self, name: str, shape: Sequence[int], dtype=torch.float32) -> str:
        """Declare a transient resource, written anew every frame."""
        return self._declare(name, shape, dtype, temporal=False)

    buffer = image  # buffers and images are both tensors here

    def temporal(self, name: str, shape: Sequence[int], dtype=torch.float32) -> str:
        """Declare a ping-pong resource: passes may read ``name@prev`` and
        write ``name``; the value persists across frames in the state."""
        return self._declare(name, shape, dtype, temporal=True)

    def add_pass(self, name: str, fn: Callable[..., Dict[str, Any]], reads: Sequence[str] = (),
                 writes: Sequence[str] = ()) -> None:
        """``fn(resources_dict, **constants) -> {written_name: tensor}``.

        Raises as the reference builder does: a duplicate pass name, a
        resource listed twice by one pass (read and written in one frame
        takes the @prev slot), an undeclared resource, @prev of a
        non-temporal resource, a pass that writes nothing."""
        if name in self._pass_names:
            raise GraphError(f"duplicate pass name {name!r}")
        self._pass_names.add(name)
        seen = set()
        for r in tuple(reads) + tuple(writes):
            if r in seen:
                raise GraphError(f"pass {name!r} declares resource {r!r} twice")
            seen.add(r)
            base = r.split("@")[0]
            if base not in self._resources:
                raise GraphError(f"pass {name!r} references undeclared resource {r!r}")
            if r.endswith("@prev") and not self._resources[base].temporal:
                raise GraphError(f"pass {name!r} reads {r!r} but {base!r} is not temporal")
        if not writes:
            raise GraphError(f"pass {name!r} writes nothing")
        self._passes.append(_Pass(name, fn, tuple(reads), tuple(writes)))

    def _order(self, output: str) -> List[_Pass]:
        """The passes the output needs, in execution order: a DFS from its
        writer; @prev reads add no edge (they come from the state)."""
        writer_of: Dict[str, _Pass] = {}
        for p in self._passes:
            for w in p.writes:
                if w in writer_of:
                    raise GraphError(f"resource {w!r} written by both {writer_of[w].name!r} and {p.name!r}")
                writer_of[w] = p
        if output not in writer_of:
            raise GraphError(f"no pass writes the requested output {output!r}")

        order: List[_Pass] = []
        visiting: set[str] = set()
        done: set[str] = set()

        def visit(p: _Pass):
            if p.name in done:
                return
            if p.name in visiting:
                raise GraphError(f"cycle through pass {p.name!r}")
            visiting.add(p.name)
            for r in p.reads:
                if r.endswith("@prev"):
                    continue
                w = writer_of.get(r)
                if w is None:
                    raise GraphError(f"pass {p.name!r} reads {r!r} which no pass writes")
                visit(w)
            visiting.discard(p.name)
            done.add(p.name)
            order.append(p)

        visit(writer_of[output])
        return order

    def init_state(self, device) -> Dict[str, torch.Tensor]:
        """The temporal state: every ping-pong resource, zeroed, on
        ``device``."""
        return {r.name: torch.zeros(r.shape, dtype=r.dtype, device=device)
                for r in self._resources.values() if r.temporal}

    def _check_decl(self, pass_name: str, name: str, value) -> None:
        """A written value must match its declaration."""
        r = self._resources[name.split("@")[0]]
        if tuple(value.shape) != r.shape:
            raise GraphError(f"pass {pass_name!r} wrote {name!r} with shape {tuple(value.shape)} but it was "
                             f"declared {r.shape}")
        if value.dtype != r.dtype:
            raise GraphError(f"pass {pass_name!r} wrote {name!r} with dtype {value.dtype} but it was declared "
                             f"{r.dtype}")

    def compile(self, output: str, jit: bool = True, donate_state: bool = True, bindings: Any = None):
        """Bake the execution order and return ``step(state, **constants)
        -> (output_value, new_state)``. ``bindings`` (the scene, a
        backend's tables: the bindless heap's counterpart) is passed to
        every pass whose function has a ``bindings`` parameter. The step's
        ``pass_order`` is the baked order, a tuple of pass names: on a CUDA
        device marker I runs before ``pass_order[I]`` and marker
        ``len(pass_order)`` after the last pass.

        ``jit=True`` on a CUDA device runs the step as a CUDA graph
        (``capture_step``; the reference's ``jax.jit``): tensor constants
        and Python numbers are the graph's inputs (a pass sees a number as
        a 0-d tensor), anything else and every shape is part of its
        signature. A pass that reads the device from the host cannot be
        captured: the step then raises, naming the pass; ``jit=False``
        runs it eagerly. On the CPU the step runs eagerly either way.
        ``donate_state=True`` lets the step reuse and overwrite the state
        tensors it is given (the state it returns is the graph's own);
        ``donate_state=False`` leaves them as they were, as the eager step
        always does."""
        order = self._order(output)
        wants_bindings = {p.name: "bindings" in inspect.signature(p.fn).parameters for p in order}
        labels = {p.name: f"pass:{p.name}" for p in order}
        temporal = [r.name for r in self._resources.values() if r.temporal]
        running = [None]  # the pass being run, for the capture's error

        def step(state: Dict[str, torch.Tensor], **constants):
            dev = _cuda_device(state, constants)
            env: Dict[str, Any] = {name + "@prev": state[name] for name in temporal}
            for i, p in enumerate(order):
                running[0] = p.name
                _mark(i, dev)
                with profiling.span(labels[p.name]):
                    kw = dict(constants, bindings=bindings) if wants_bindings[p.name] else constants
                    out = p.fn({r: env[r] for r in p.reads}, **kw)
                if set(out) != set(p.writes):
                    raise GraphError(f"pass {p.name!r} returned {sorted(out)} but declared writes "
                                     f"{sorted(p.writes)}")
                for k, v in out.items():
                    self._check_decl(p.name, k, v)
                env.update(out)
            running[0] = None
            _mark(len(order), dev)
            return env[output], {name: env.get(name, state[name]) for name in temporal}

        run = step if not jit else capture_step(
            step, donate_state,
            where=lambda: "the state's write-back" if running[0] is None else f"pass {running[0]!r}")
        run.pass_order = tuple(p.name for p in order)
        return run


def _cuda_device(state: Dict[str, torch.Tensor], constants: Dict[str, Any]):
    """The CUDA device of the step's first tensor on one, else None."""
    for t in itertools.chain(state.values(), pytree.tree_leaves(constants)):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            return t.device
    return None


def _mark(boundary: int, dev) -> None:
    """The pass marker of ``boundary`` on a CUDA device; nothing
    elsewhere."""
    if dev is not None:
        from raytracer3_tpu_torch.ops import traverse_kernel as tk

        tk.pass_mark(boundary, dev)


# ---------------------------------------------------------------------------
# The compiled step: one CUDA graph per signature
# ---------------------------------------------------------------------------

_MAX_GRAPHS = 8  # signatures kept per step; the oldest capture is dropped


def _launch_counts() -> Dict[str, int]:
    """The kernel wrappers' launch counters (``traverse_kernel.LAUNCHES``)."""
    from raytracer3_tpu_torch.ops import traverse_kernel as tk

    return tk.LAUNCHES


def _static_leaf(x, dev: torch.device) -> torch.Tensor:
    """A graph input's buffer: a tensor's copy, a Python number's 0-d
    tensor (int64, float32 or bool, as ``jax.jit`` traces a number)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    dtype = torch.bool if isinstance(x, bool) else torch.int64 if isinstance(x, int) else torch.float32
    return torch.full((), x, dtype=dtype, device=dev)


def _signature_of(x):
    """A graph input's part of the signature: a tensor's shape, dtype and
    device, a Python number's type, anything else's (hashable) value."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype, x.device
    if isinstance(x, (bool, int, float)):
        return type(x)
    return "value", x


class _Captured:
    """One signature's CUDA graph: static buffers of the state and the
    inputs, the captured outputs, and the launches the capture recorded."""

    def __init__(self, graph, state, leaves, out, launches):
        self.graph, self.state, self.leaves, self.out, self.launches = graph, state, leaves, out, launches

    def state_out(self, donate_state: bool):
        return dict(self.state) if donate_state else {k: v.clone() for k, v in self.state.items()}

    def replay(self, state, leaves):
        with profiling.span("graph:run"):
            for k, v in state.items():
                if v is not self.state[k]:
                    self.state[k].copy_(v)
            for buf, x in zip(self.leaves, leaves):
                if not isinstance(x, torch.Tensor):
                    buf.fill_(x)
                elif x is not buf:
                    buf.copy_(x)
            self.graph.replay()
            counts = _launch_counts()
            for k, n in self.launches.items():
                counts[k] += n
            return _fresh(self.out)


def _fresh(tree):
    return pytree.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


def capture_step(fn: Callable, donate_state: bool = True, where: Callable[[], str] = lambda: "the step"):
    """``fn(state, **inputs) -> (out, new_state)`` (``new_state`` with the
    keys, shapes and dtypes of ``state``) as a CUDA graph on the device of
    its tensors; eager when none is on a CUDA device.

    The first call of a signature (the state's keys, the inputs' structure,
    every tensor's shape, dtype and device, the type of each Python number
    and the value of anything else) runs ``fn`` once eagerly on a side
    stream (kernel builds, caches) and returns that run's results; it then
    captures ``fn`` on the same stream, with static buffers for the state
    and for every tensor and number of the inputs. Each later call copies
    its inputs into the buffers (a tensor that is the buffer already is
    left alone), replays the graph and adds the launch counts the capture
    recorded to ``traverse_kernel.LAUNCHES`` (the wrappers' Python counters
    do not run on a replay). Every tensor of ``out`` is a fresh copy, so a
    caller may hold earlier outputs while the graph runs again.
    ``donate_state=True`` returns the static state buffers themselves (the
    next call's state copy is then skipped), ``donate_state=False`` copies.
    A capture that fails raises ``GraphError`` naming ``where()``, the
    part of ``fn`` that was running; nothing falls back to eager."""
    graphs: Dict[Any, _Captured] = {}

    def call(state: Dict[str, torch.Tensor], **inputs):
        leaves, spec = pytree.tree_flatten(inputs)
        devs = {t.device for t in list(state.values()) + leaves
                if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
        if not devs:
            with profiling.span("graph:run"):
                return fn(state, **inputs)
        if len(devs) > 1:
            raise GraphError(f"a compiled step runs on one device, got {sorted(map(str, devs))}")
        key = (tuple((k, _signature_of(v)) for k, v in state.items()), repr(spec),
               tuple(_signature_of(x) for x in leaves))
        cap = graphs.get(key)
        if cap is not None:
            return cap.replay(state, leaves), cap.state_out(donate_state)
        out, cap = _capture(fn, state, leaves, spec, devs.pop(), where)
        if len(graphs) >= _MAX_GRAPHS:
            graphs.pop(next(iter(graphs)))
        graphs[key] = cap
        return out, cap.state_out(donate_state)

    return call


def _capture(fn, state, leaves, spec, dev, where):
    """The first call of a signature: the eager warm-up on the side stream,
    then the capture. Returns (the warm-up's out, ``_Captured`` holding
    the warm-up's new state)."""
    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    st = {k: v.clone() for k, v in state.items()}
    bufs = [_static_leaf(x, dev) for x in leaves]

    def run():
        out, new = fn(dict(st), **pytree.tree_unflatten(bufs, spec))
        if set(new) != set(st):
            raise GraphError(f"the step returned the state {sorted(new)} for {sorted(st)}")
        return out, new

    side.wait_stream(main)
    with torch.cuda.stream(side):
        out_w, new_w = run()
    counts = _launch_counts()
    before = dict(counts)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.stream(side):  # restores the stream when the capture fails
            with torch.cuda.graph(graph, stream=side):
                out_c, new_c = run()
                for k, v in new_c.items():
                    if v is not st[k]:
                        st[k].copy_(v)
    except Exception as exc:  # noqa: BLE001 — re-raised with the pass named
        first = exc
        while first.__context__ is not None and first.__cause__ is None:
            first = first.__context__
        raise GraphError(f"capturing the step as a CUDA graph failed in {where()}: {type(first).__name__}: {first} "
                         f"(a step that reads the device from the host cannot be captured; compile(..., "
                         f"jit=False) runs it eagerly)") from exc
    finally:
        launches = {k: n - before.get(k, 0) for k, n in counts.items() if n != before.get(k, 0)}
        counts.update(before)
    main.wait_stream(side)
    out = _fresh(out_w)
    for k, v in new_w.items():
        st[k].copy_(v)
    # The warm-up's tensors were allocated on the side stream and are read
    # above on the main one: later work on the side stream (which may reuse
    # their memory once they are freed) waits for those reads.
    side.wait_stream(main)
    return out, _Captured(graph, st, bufs, out_c, launches)
