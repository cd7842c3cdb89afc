"""CUDA graphs of a function of tensors, one per input signature.

A chain of small launches that the host paces (RAFT's update block: ~70
launches of a few microseconds each) costs the host more time than the
card. ``GraphCache`` captures the function once per signature, with the
inputs copied into the graph's own tensors, and afterwards replays the
graph: one launch for the chain. The same kernels run on the same values,
so the outputs are the eager calls' bit for bit where the libraries choose
the same algorithms under capture, which they do at fixed settings.

``GraphCache`` decides when a call may replay (:meth:`GraphCache.engages`)
and builds its signature (:meth:`GraphCache.signature`): every property of
the call that the captured kernels depend on and that the graph cannot
read anew at replay. A caller may keep a call eager for a reason of its
own, and decides what becomes of the graph's outputs.
"""

from __future__ import annotations

import collections
import copy

import torch

from feature_tracker_tpu_torch.utils.profiling import count

WARM_UP = 3     # eager calls on the capture's stream before the capture


class _Graph:
    __slots__ = ("graph", "inputs", "outputs", "last")

    def __init__(self, graph, inputs, outputs):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.last = None    # the last call's inputs, if it gave ``reuse``


class GraphCache:
    """The graphs of one function of the module ``owner``, at most
    ``size``, the least recently replayed released first. A call copies its
    inputs into the graph's inputs (each cast to its entry of ``dtypes``
    where that is not None: one launch for the cast and the copy) and
    replays the graph; it returns the graph's own output tensors, which the
    next call with the same signature overwrites. Counts
    ``<name>.captures`` and ``<name>.replays`` in the port's tracer."""

    def __init__(self, name: str, owner, size: int = 4):
        self.name, self.size = name, size
        self.modules = list(owner.modules())
        self.graphs: collections.OrderedDict = collections.OrderedDict()

    @staticmethod
    def engages(inputs) -> bool:
        """Whether a call on ``inputs`` may replay a graph: the inputs are
        on the card (the first one's device, which the graph is captured
        on), autograd is off (``torch.inference_mode`` or ``no_grad``) and
        no stream capture is in progress."""
        return (inputs[0].is_cuda and not torch.is_grad_enabled()
                and not torch.cuda.is_current_stream_capturing())

    def signature(self, inputs) -> tuple:
        """The key of the graph of a call on ``inputs``: the inputs' shapes
        and dtypes, their device, inference mode, cuDNN's ``enabled``,
        ``benchmark``, ``deterministic`` and ``allow_tf32``, the matrix
        products' ``allow_tf32``, and the addresses of the owner's
        parameters, read anew at each call: a parameter that is replaced
        (``load_state_dict(assign=True)``) gives a new key."""
        cudnn = torch.backends.cudnn
        return (tuple((x.shape, x.dtype) for x in inputs), inputs[0].device,
                torch.is_inference_mode_enabled(), cudnn.enabled,
                cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32,
                tuple(p.data_ptr() for m in self.modules
                      for p in m._parameters.values() if p is not None))

    def __call__(self, fn, inputs, dtypes=None, reuse=False):
        """``fn(*inputs)`` (a tuple of tensors that :meth:`engages`)
        through the graph of its signature, captured first if there is
        none. An input that is the graph's own input tensor (``fn`` may
        return one) is not copied; with ``reuse``, neither is one that is
        the tensor given at the last call, if that call gave ``reuse`` too:
        the caller vouches that it has not changed since."""
        key = self.signature(inputs)
        entry = self.graphs.get(key)
        if entry is None:
            entry = self._capture(fn, inputs, dtypes)
            if len(self.graphs) == self.size:
                self.graphs.popitem(last=False)
            self.graphs[key] = entry
            count(self.name + ".captures")
        else:
            self.graphs.move_to_end(key)
        last = entry.last if reuse else None
        dst, src = [], []
        for k, (static, x) in enumerate(zip(entry.inputs, inputs)):
            if x is not static and (last is None or x is not last[k]):
                dst.append(static)
                src.append(x)
        if dst:
            torch._foreach_copy_(dst, src)
        entry.last = inputs if reuse else None
        entry.graph.replay()
        count(self.name + ".replays")
        return entry.outputs

    @staticmethod
    def _capture(fn, inputs, dtypes):
        """Warm ``fn`` up on a side stream, as capture requires (libraries
        make their handles and plans), then capture it on that stream."""
        device = inputs[0].device
        with torch.cuda.device(device):
            static = [x.to(dt or x.dtype, copy=True) for x, dt in zip(
                inputs, dtypes or [None] * len(inputs))]
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                for _ in range(WARM_UP):
                    fn(*static)
            torch.cuda.current_stream().wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                outputs = fn(*static)
        return _Graph(graph, static, outputs)

    def __deepcopy__(self, memo):
        """A copy starts empty (a graph holds its module's addresses), over
        the copied owner's modules: the owner's copy has copied them before
        this attribute, so ``memo`` maps them to the copies."""
        new = copy.copy(self)
        new.graphs = collections.OrderedDict()
        new.modules = copy.deepcopy(self.modules, memo)
        return new
