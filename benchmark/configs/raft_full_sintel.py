"""Session of the ``raft_full_sintel`` configuration: the port's RAFT at the
paper's full-model widths, ``Raft.forward`` on a batch of consecutive frame
pairs a call, host ``uint8`` RGB frames in, the flow on the card after a
synchronise, held to ``reference/raft.py``. The weights are drawn from the
seed on the card (``reference.raft.draw_weights``) and the batch
normalisations' statistics set from the first pair
(``reference.raft.fit_batch_stats``); the port and the reference each take
them from there.

What is compared (once the window has closed): ``CHECK_PAIRS`` pairs' flows
from calls of the window drawn from the seed (a reservoir sample over all
calls), each against the plain float32 reference run on the same frames
with the same weights. The numbers compared, of the endpoint distance
between the port's flow and the reference's at each pixel: its mean over a
pair's pixels (``flow_epe_gap_px``) and its 99th percentile
(``flow_p99_gap_px``), each the largest over the sampled pairs. Each limit
lies between the port's readings over a dozen seeds (lower) and the
control's, the reference with float8 convolutions in the port's place
(upper); see ``PERF.md``.
"""

from __future__ import annotations

import dataclasses
import math
import random

import numpy as np
import torch

from benchmark import frames, work
from benchmark.harness import Reservoir
from benchmark.reference import raft as ref

CHECK_PAIRS = 16
LIMITS = {"flow_epe_gap_px": 0.12, "flow_p99_gap_px": 0.3}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
STATE_NAMES = {"kernel": "weight", "bias": "bias", "scale": "weight",
               "mean": "running_mean", "var": "running_var"}


def port_config(cfg):
    from feature_tracker_tpu_torch.models.raft import RaftConfig

    fields = {f.name for f in dataclasses.fields(RaftConfig)}
    kw = {k: v for k, v in cfg.items() if k in fields}
    kw["dtype"] = DTYPES[cfg["dtype"]]
    return RaftConfig(**kw)


def port_state(tree):
    """A weight tree (``reference.raft.draw_weights``) as the port's
    ``state_dict``, on the tree's device: a leaf's module path is its key,
    kernels ``[kh, kw, in, out]`` become ``[out, in, kh, kw]``."""
    state = {}

    def walk(node, path):
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                walk(leaf, path + (name,))
                continue
            key = ".".join(path[1:] + (STATE_NAMES[name],))
            state[key] = (leaf.permute(3, 2, 0, 1).contiguous()
                          if name == "kernel" else leaf)
            if name == "mean":
                state[".".join(path[1:] + ("num_batches_tracked",))] = (
                    torch.zeros((), dtype=torch.long))

    walk(tree, ())
    return state


class Session:
    call_span = "raft.forward"

    def __init__(self, cfg, traffic, seed, device):
        from feature_tracker_tpu_torch.models.raft import Raft

        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.batch = int(traffic["batch"])
        self.frames_per_call = self.batch
        self.tree = ref.draw_weights(cfg, seed, self.device)
        # One texture a colour channel, under the one camera path.
        tex = cfg["texture"]
        ring = np.stack([frames.render_ring(
            frames.Texture(**dict(tex, seed=tex["seed"] + c)),
            cfg["height"], cfg["width"], traffic, seed, self.device)
            for c in range(cfg["in_channels"])], -1)
        period = frames.sequence_period(traffic, len(ring))
        calls = period // math.gcd(period, self.batch)
        self.inputs = []
        for j in range(calls):
            idx = [frames.frame_index(traffic, len(ring), j * self.batch + k)
                   for k in range(self.batch + 1)]
            self.inputs.append((np.ascontiguousarray(ring[idx[:-1]]),
                                np.ascontiguousarray(ring[idx[1:]])))
        ref.fit_batch_stats(self.tree, cfg, *self.inputs[0], self.device)
        self.model = Raft(port_config(cfg), device=self.device)
        self.model.load_state_dict(port_state(self.tree))
        self.tracer = None
        self._work = {}
        self.locations = []

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def warm_up(self):
        for j in range(2):
            self.model(*self.inputs[j % len(self.inputs)])
        self._sync()

    def start_window(self):
        self.kept = Reservoir(max(1, CHECK_PAIRS // self.batch),
                              random.Random(self.seed))

    def call(self, i):
        flow = self.model(*self.inputs[i % len(self.inputs)])
        self._sync()
        return flow

    def keep(self, i, flow):
        self.kept.offer((i, flow))

    def install_spans(self, tracer):
        """Spans from forward hooks (each after a synchronise) on the two
        encoders and the update block, around each lookup (recording the
        first call's locations for the work arithmetic) and each call."""
        self.tracer = tracer
        m = self.model
        tracer.hook(m.feature_enc, "raft.feature_enc")
        tracer.hook(m.context_enc, "raft.context_enc")
        tracer.hook(m.UpdateBlock_0, "raft.UpdateBlock_0")
        lookup = m.lookup_fn

        def recorded(fmap0, pyr, locations, radius):
            if tracer.call == 0:
                self.locations.append(
                    (tuple(fmap0.shape), [tuple(p.shape) for p in pyr],
                     locations.detach().clone(), radius))
            return lookup(fmap0, pyr, locations, radius)

        m.lookup_fn = tracer.wrap("raft.lookup", recorded)
        self.call = tracer.wrap(self.call_span, self.call)

    def finish(self):
        """Drop the port's model (after the window's memory peak is read)."""
        self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference --------------------------------------------------------

    def compare(self, control=False):
        """Per sampled pair, the mean and the 99th percentile over pixels of
        the endpoint distance to the reference's flow; the port's flow, or
        with ``control`` the float8 reference's in its place. The reference
        takes one pair at a time: its batch normalisations use fixed
        statistics, so a pair's flow does not depend on the batch."""
        want_fn = ref.RaftReference(self.tree, self.cfg, self.device)
        got_fn = (ref.RaftReference(self.tree, self.cfg, self.device, True)
                  if control else None)
        means, p99s = [], []
        for i, flow in sorted(self.kept.items, key=lambda kv: kv[0]):
            ref_u8, cur_u8 = self.inputs[i % len(self.inputs)]
            for k in range(len(ref_u8)):
                pair = (ref_u8[k:k + 1], cur_u8[k:k + 1])
                want = want_fn(*pair)[0]
                got = got_fn(*pair)[0] if control else flow[-1, k].float()
                d = torch.linalg.vector_norm(got - want, dim=-1)  # [H, W]
                means.append(float(d.mean()))
                p99s.append(float(torch.quantile(d.flatten(), 0.99)))
        return {"flow_epe_gap_px": max(means), "flow_p99_gap_px": max(p99s)}

    def verify(self):
        got = self.compare()
        return [(k, got[k], v) for k, v in LIMITS.items()]

    # -- work arithmetic of the traced calls ---------------------------------

    def traced_work(self, calls):
        if calls not in self._work:
            self._work[calls] = self._traced_work(calls)
        return self._work[calls]

    def _traced_work(self, calls):
        """FLOPs of one call and kernel 5's bytes and FLOPs per launch, on
        the first traced call's own lookup locations."""
        looks = [work.lookup_work(f0, pyr, locs, r)
                 for f0, pyr, locs, r in self.locations]
        if not looks:
            return None
        nbytes = float(np.mean([b for b, _ in looks]))
        flops = float(np.mean([f for _, f in looks]))
        call = work.raft_flops(self.cfg, self.batch, self.cfg["height"],
                               self.cfg["width"], flops)
        return {"lookup_bytes": nbytes, "lookup_flops": flops,
                "call_flops": call}
