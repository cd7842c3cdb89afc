"""Checkpoint / resume for training state — the counterpart of
``feature_tracker_tpu/train/checkpoint.py`` (Orbax there, ``torch.save``
here).

Save and restore the whole ``TrainState`` (parameters, batch statistics,
optimizer state, step) with retention and an atomic finalize: each step is
written into a temporary directory beside its final one and renamed into
place (``os.replace``), so a reader never sees half a checkpoint. The
saving rules are Orbax's: the first save into an empty directory always
happens, later ones only at steps that are multiples of
``save_interval_steps``, and a step at or before the latest saved one is
refused; the oldest checkpoints beyond ``max_to_keep`` are deleted.

With a mesh (data-parallel training) the state is the same on every rank,
so rank 0 writes and every rank of the mesh waits until it has written;
each rank restores from the shared directory.
"""

from __future__ import annotations

import dataclasses
import os
import shutil

import torch

_FILE = "state.pt"


def _tree(obj):
    """Dataclasses (such as a ``TrainState``) and dicts as nested dicts of
    tensors, for ``torch.save``."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _tree(v) for k, v in obj.items()}
    return obj


def _restore_into(like, tree, where: str):
    """``like``'s structure with the leaves of ``tree``, each tensor on the
    device and in the dtype of ``like``'s leaf."""
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        names = [f.name for f in dataclasses.fields(like)]
        _same_keys(names, tree, where)
        return dataclasses.replace(like, **{
            n: _restore_into(getattr(like, n), tree[n], f"{where}.{n}")
            for n in names})
    if isinstance(like, dict):
        _same_keys(list(like), tree, where)
        return {k: _restore_into(v, tree[k], f"{where}.{k}")
                for k, v in like.items()}
    if isinstance(like, torch.Tensor):
        if tuple(tree.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf {where} has shape "
                             f"{tuple(tree.shape)}, the state "
                             f"{tuple(like.shape)}")
        return tree.to(device=like.device, dtype=like.dtype)
    return tree


def _same_keys(keys, tree, where: str) -> None:
    if not isinstance(tree, dict) or set(tree) != set(keys):
        theirs = sorted(tree) if isinstance(tree, dict) else type(tree)
        raise ValueError(f"checkpoint at {where or 'the root'} holds "
                         f"{theirs}, the state {sorted(keys)}")


class CheckpointManager:
    """Saves and restores training states under ``directory``, one
    subdirectory per step."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1, mesh=None):
        self._dir = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        self._interval = save_interval_steps
        self._mesh = mesh
        os.makedirs(self._dir, exist_ok=True)

    def _is_writer(self) -> bool:
        if self._mesh is None:
            return True
        import torch.distributed as dist
        return dist.get_rank() == 0

    def _mesh_sum(self, value: float) -> float:
        """``value`` summed over the ranks of the mesh (an all-reduce of one
        element through the mesh's collectives): every rank waits there
        until each has arrived."""
        from feature_tracker_tpu_torch.parallel.mesh import _all_reduce
        return float(_all_reduce(self._mesh, torch.full(
            (1,), value, device=torch.device(self._mesh.device_type))))

    def _should_save(self, step: int) -> bool:
        latest = self.latest_step()
        if latest is None:
            return True
        return step > latest and step % self._interval == 0

    def save(self, step: int, state) -> bool:
        """Save state at step; returns True if a save actually happened
        (the manager skips off-interval steps)."""
        step = int(step)
        saved = self._is_writer() and self._should_save(step)
        if self._mesh is not None:
            # Rank 0's decision, on every rank, before it writes anything.
            saved = self._mesh_sum(float(saved)) > 0
        if saved and self._is_writer():
            final = os.path.join(self._dir, str(step))
            tmp = f"{final}.tmp-{os.getpid()}"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(_tree(state), os.path.join(tmp, _FILE))
            os.replace(tmp, final)
            if self._max_to_keep is not None:
                for old in self.all_steps()[:-self._max_to_keep]:
                    shutil.rmtree(os.path.join(self._dir, str(old)))
        if self._mesh is not None:
            self._mesh_sum(0.0)        # the others wait for the write
        return saved

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like, step: int | None = None):
        """Restore into the structure of ``state_like``: every tensor comes
        back on the device and in the dtype of ``state_like``'s. Returns
        the restored state."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self._dir}")
        path = os.path.join(self._dir, str(int(step)), _FILE)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint of step {step} in "
                                    f"{self._dir}")
        tree = torch.load(path, map_location="cpu", weights_only=True)
        return _restore_into(state_like, tree, "")

    def all_steps(self):
        return sorted(int(name) for name in os.listdir(self._dir)
                      if name.isdigit()
                      and os.path.isdir(os.path.join(self._dir, name)))

    def close(self):
        """Nothing is pending: every save is finished when it returns."""
