"""DeviceFlow — the paper's cudaFlow (§3.5) over CUDA graphs.

A DeviceFlow task records a graph of device operations at its execution
context — host-to-device copies, kernels, device-to-host fetches — and
offloads the whole graph with **one host call**. On CUDA this is what the
paper built cudaFlow as: the op list is captured once into a
``torch.cuda.CUDAGraph`` and every launch is one ``replay()``, however many
kernels the graph holds (the paper's first design advantage).

Stateful parameter capture (§3.5.2, the second advantage): each ``copy``
name owns a static device buffer that the graph reads, filled by a memcpy
node of the graph from a pinned host staging buffer. Re-binding the name
before the next offload (``copy(name, new)``, or assigning
``_inputs[name]`` as ``benchmarks/fig13_lsdnn.py`` does) copies the new
array into the staging buffer, so the same graph runs on new data; the new
array must keep the shape and dtype, or the offload raises. Each ``fetch``
name is copied into a pinned host buffer inside the graph too (a replay
overwrites the graph's outputs), one stream sync follows each
``offload(n)``, and :meth:`result` returns numpy arrays, as
``jax.device_get`` does in the reference.

Before the capture the op list runs once eagerly on a side stream: that
builds the kernels (:func:`repro_torch.kernels.ops.ensure_built`) and does
any other one-time CUDA set-up outside the capture. The capture uses
``capture_error_mode="thread_local"``, so an ACCEL worker may capture while
HOST workers run. Ops must be capturable: no host syncs (``.item()``,
printing a tensor) and no data-dependent shapes.

Nested programs (the third advantage, ``repro.core.deviceflow``'s nested
``JaxGraph``): an op may be a compiled
:class:`repro_torch.core.CondGraph` program. Captured, a conditional
program builds its WHILE/IF nodes into the flow's graph
(:meth:`repro_torch.kernels.cond_graph.CondProgram.nest`), so one replay
runs the flow's ops and the whole loop with no host round trip a trip; a
compiled DAG runs its composition into the capture. The program counts
one launch, at the capture, and none per replay. On the CPU the compiled
program is ``CondGraph.lower()``'s function and runs eagerly in the flow.

Kernel launch counters tick when a wrapper launches, which for a captured
graph is once, at capture. :attr:`DeviceFlow.captured_launches` holds the
counts recorded into the graph, so a run's device launches are its eager
calls plus ``captured_launches[k] * num_launches``.

On ``device="cpu"`` the op list runs eagerly at every launch, with the same
counts and results. ``device=None`` means CUDA and raises when there is
none: nothing falls back to the CPU.

Differences from the reference (``repro.core.deviceflow``), and why: XLA
finds the dependencies of a ``jax.jit`` program from array use; a CUDA
graph captured on one stream orders the ops as recorded, which is the same
order. Both take insertion order as the program order.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ..device import collection_paused, resolve_device

__all__ = ["DeviceFlow"]


def _host_tensor(value: Any) -> torch.Tensor:
    t = value if isinstance(value, torch.Tensor) else torch.as_tensor(value)
    return t.detach()


def _numpy(t: Any) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"DeviceFlow.fetch: {type(t).__name__} is not a "
                        "tensor")
    return t.detach().cpu().numpy().copy()


class _Captured:
    """The CUDA graph of one DeviceFlow and the buffers it reads and
    writes: static device inputs, their pinned staging buffers and the
    pinned fetch buffers."""

    def __init__(self, flow: "DeviceFlow") -> None:
        from ..kernels import ops

        dev = flow.device
        host = {k: _host_tensor(v) for k, v in flow._inputs.items()}
        self.static = {k: torch.empty(h.shape, dtype=h.dtype, device=dev)
                       for k, h in host.items()}
        self.staging = {k: torch.empty(h.shape, dtype=h.dtype,
                                       pin_memory=True)
                        for k, h in host.items()}
        self.stage(flow._inputs)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):        # warm-up, outside the capture
            out = self._program(flow)
            self.fetched = {}
            for k, v in out.items():
                if not isinstance(v, torch.Tensor) or v.device != dev:
                    raise TypeError(f"DeviceFlow.fetch({k!r}): expected a "
                                    f"tensor on {dev}, got {type(v)}")
                self.fetched[k] = torch.empty(v.shape, dtype=v.dtype,
                                              pin_memory=True)
        side.synchronize()
        del out
        self.graph = torch.cuda.CUDAGraph()
        before = ops.launch_counts()
        with collection_paused(), torch.cuda.graph(
                self.graph, stream=side, capture_error_mode="thread_local"):
            out = self._program(flow)
            for k, v in out.items():
                self.fetched[k].copy_(v, non_blocking=True)
        after = ops.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}

    def _program(self, flow: "DeviceFlow") -> Dict[str, Any]:
        for k, buf in self.static.items():
            buf.copy_(self.staging[k], non_blocking=True)
        return flow._run(dict(self.static))

    def stage(self, inputs: Dict[str, Any]) -> None:
        """Copy the inputs' current bindings into the staging buffers."""
        for k, v in inputs.items():
            self.staging[k].copy_(_host_tensor(v))


class DeviceFlow:
    """Capture-and-launch device graph, bound to a worker's device."""

    def __init__(self, device: Any = None) -> None:
        self.device = resolve_device(device)
        self._inputs: Dict[str, Any] = {}
        self._ops: List[Tuple[Callable, List[str], List[str], str]] = []
        self._fetch: List[str] = []
        self._results: Dict[str, Any] = {}
        self._captured: _Captured | None = None
        self._signature: Dict[str, tuple] | None = None
        self._num_launches = 0

    # -- capture API ------------------------------------------------------------
    def copy(self, name: str, host_array: Any) -> "DeviceFlow":
        """H2D transfer task: make ``host_array`` available as ``name``."""
        self._inputs[name] = host_array
        return self

    def kernel(self, fn: Callable, inputs: List[str], outputs: List[str],
               name: str = "") -> "DeviceFlow":
        """Device op task: ``outputs = fn(*inputs)`` (any PyTorch
        computation on the device's tensors, kernels included)."""
        self._ops.append((fn, list(inputs), list(outputs),
                          name or getattr(fn, "__name__", "op")))
        return self

    def fetch(self, *names: str) -> "DeviceFlow":
        """D2H transfer task: copy ``names`` back after the launch."""
        self._fetch.extend(names)
        return self

    def call(self, fn: Callable, *args: Any, out: str = "out") -> "DeviceFlow":
        """Convenience: capture ``out = fn(*args)`` with positional host
        args."""
        arg_names = []
        for i, a in enumerate(args):
            n = f"__arg{len(self._inputs)}_{i}"
            self._inputs[n] = a
            arg_names.append(n)
        self._ops.append((fn, arg_names, [out], getattr(fn, "__name__", "call")))
        self._fetch.append(out)
        return self

    # -- launch -------------------------------------------------------------------
    def _run(self, env: Dict[str, Any]) -> Dict[str, Any]:
        """The op list, eagerly, on the tensors of ``env``. A value is
        dropped after its last use unless it is fetched, so a captured
        graph's pool reuses its memory (as XLA frees dead buffers)."""
        last = {}
        for i, (_, ins, _, _) in enumerate(self._ops):
            for name in ins:
                last[name] = i
        for i, (fn, ins, outs, _) in enumerate(self._ops):
            vals = fn(*[env[n] for n in ins])
            if len(outs) == 1:
                env[outs[0]] = vals
            else:
                for o, v in zip(outs, vals):
                    env[o] = v
            for name in ins:
                if last[name] == i and name not in self._fetch:
                    del env[name]
        return {k: env[k] for k in self._fetch}

    def _check_inputs(self) -> None:
        """The first launch fixes each input's shape and dtype (the graph's
        static buffers); a re-bound input must keep them."""
        sig = {}
        for k, v in self._inputs.items():
            t = _host_tensor(v)
            sig[k] = (tuple(t.shape), t.dtype)
        if self._signature is None:
            self._signature = sig
            return
        if set(sig) != set(self._signature):
            raise ValueError(f"DeviceFlow inputs changed after the first "
                             f"launch: {sorted(sig)} vs "
                             f"{sorted(self._signature)}")
        for k, (shape, dtype) in sig.items():
            if dtype != self._signature[k][1]:
                raise TypeError(f"DeviceFlow input {k!r}: dtype {dtype}, "
                                f"first launched as {self._signature[k][1]}")
            if shape != self._signature[k][0]:
                raise ValueError(f"DeviceFlow input {k!r}: shape {shape}, "
                                 f"first launched as {self._signature[k][0]}")

    def bound(self):
        """Context binding the calling thread to this flow's CUDA device."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _offload(self, launches: int = 1) -> Dict[str, Any]:
        """Capture once, launch ``launches`` times (paper cudaFlow
        offload), sync once and fetch."""
        n = max(1, launches)
        self._check_inputs()
        if self.device.type != "cuda":
            for _ in range(n):
                env = {k: _host_tensor(v).to(self.device, copy=True)
                       for k, v in self._inputs.items()}
                out = self._run(env)
                self._num_launches += 1
            self._results = {k: _numpy(v) for k, v in out.items()}
            return self._results
        with self.bound():
            if self._captured is None:
                self._captured = _Captured(self)
            cap = self._captured
            cap.stage(self._inputs)
            for _ in range(n):
                cap.graph.replay()
                self._num_launches += 1
            torch.cuda.current_stream(self.device).synchronize()
            self._results = {k: _numpy(v) for k, v in cap.fetched.items()}
        return self._results

    def offload(self, n: int = 1) -> Dict[str, Any]:
        return self._offload(n)

    def close(self) -> None:
        """Free the captured CUDA graph now (the next offload captures
        anew), so it never waits in a reference cycle for the garbage
        collector, which could destroy it inside another capture."""
        if self._captured is not None:
            self._captured.graph.reset()
            self._captured = None

    def result(self, name: str) -> Any:
        return self._results[name]

    @property
    def num_launches(self) -> int:
        """Launches of the whole graph (CUDA graph replays on CUDA)."""
        return self._num_launches

    @property
    def captured_launches(self) -> Dict[str, int]:
        """Kernel launches recorded into the CUDA graph, by kernel (empty
        before the first CUDA offload and on the CPU)."""
        return dict(self._captured.launches) if self._captured else {}
