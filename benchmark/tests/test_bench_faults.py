"""A run with the timed path broken underneath, or with the control (the
plain reference one precision lower, in the port's place), comes out not
``correct``: the harness's look for a card is skipped (the CPU) and the
rest of a run is driven at a small size."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.tests import helpers


def _front_end_faults():
    from feature_tracker_tpu_torch import pipeline
    from feature_tracker_tpu_torch.trackers.klt import BasicKlt

    process = pipeline.TrackingFrontEnd.process_frame
    track = BasicKlt.track

    def unchanged(self, frame):
        # The step leaves the state as it was: the previous result again.
        res = process(self, frame)
        prev = getattr(self, "_fault_prev", None)
        self._fault_prev = res
        return res if prev is None else dataclasses.replace(
            prev, frame_id=res.frame_id)

    def half_left_out(self, ref_pyr, cur_pyr, ref_uv, cur_uv=None,
                      status=None):
        # Every other lane is not tracked, and passes as if it were.
        uv, st = track(self, ref_pyr, cur_pyr, ref_uv, cur_uv, status)
        uv, st = uv.clone(), st.clone()
        uv[1::2] = torch.as_tensor(ref_uv)[1::2]
        st[1::2] = torch.where(torch.as_tensor(status)[1::2] == 3,
                               st[1::2], 1)
        return uv, st

    def altered(self, frame):
        # One answer altered where it is produced: a live lane moved.
        res = process(self, frame)
        live = np.nonzero(res.track_ids >= 0)[0]
        if len(live):
            res.uv[live[0]] += 0.25
        return res

    return {"unchanged": (pipeline.TrackingFrontEnd, "process_frame",
                          unchanged),
            "half_left_out": (BasicKlt, "track", half_left_out),
            "altered": (pipeline.TrackingFrontEnd, "process_frame", altered)}


def _raft_faults():
    from feature_tracker_tpu_torch.models.raft import Raft

    forward = Raft.forward

    def unchanged(self, ref, cur, *a, **kw):
        # The iterations leave the flow where it started: zero.
        return torch.zeros_like(forward(self, ref, cur, *a, **kw))

    def half_left_out(self, ref, cur, *a, **kw):
        half = max(1, ref.shape[0] // 2)
        flow = forward(self, ref[:half], cur[:half], *a, **kw)
        return flow.repeat(1, -(-ref.shape[0] // half), 1, 1, 1)[
            :, :ref.shape[0]]

    def altered(self, ref, cur, *a, **kw):
        flow = forward(self, ref, cur, *a, **kw).clone()
        flow[:, 0, ..., 0] += 1.0
        return flow

    return {"unchanged": (Raft, "forward", unchanged),
            "half_left_out": (Raft, "forward", half_left_out),
            "altered": (Raft, "forward", altered)}


FAULTS = {"euroc_frontend.steady": _front_end_faults,
          "euroc_frontend.churn": _front_end_faults,
          "raft_full_sintel.b1": _raft_faults,
          "raft_full_sintel.b4": _raft_faults}


# Batch 1 has no half to leave out.
CASES = [(w, f) for w in sorted(FAULTS)
         for f in ("unchanged", "half_left_out", "altered")
         if not (f == "half_left_out" and w == "raft_full_sintel.b1")]


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_broken_path_is_not_correct(monkeypatch, workload, fault):
    owner, name, broken = FAULTS[workload]()[fault]
    monkeypatch.setattr(owner, name, broken)
    result, checks = helpers.run(workload, seconds=0.3)
    assert result["correct"] is False, checks


@pytest.mark.parametrize("workload", sorted(FAULTS))
def test_the_control_is_not_correct(workload):
    """The reference one precision below the configuration's (bfloat16 for
    the float32 front end, float8 for the bfloat16 RAFT) in the port's
    place fails the limits that the port passes."""
    from benchmark import harness

    spec = helpers.spec()
    cell = harness.Cell(spec, workload,
                        patch=helpers.PATCH[helpers.config_of(spec, workload)])
    session = cell.module.Session(cell.config, cell.traffic, helpers.SEED,
                                  "cpu")
    session.warm_up()
    session.start_window()
    for i in range(6):
        session.keep(i, session.call(i))
    sound = session.verify()
    assert all(v <= limit for _, v, limit in sound), sound
    control = session.compare(control=True)
    assert any(control[k] > limit for k, _, limit in sound), control
