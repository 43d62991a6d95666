"""Fault-tolerant checkpointing (counterpart of the JAX package's
``train/checkpoint.py``).

* **Atomic**: write to ``step_<n>.tmp/`` then rename; a ``LATEST`` pointer
  is updated last, so a crash at any instant leaves a loadable state.
* **Async**: ``save_async`` snapshots the tensors to host memory, then
  writes on a background thread — the training loop is blocked only for
  the device→host copy.
* **Elastic**: tensors are stored whole on the host (a DTensor's full
  value); ``restore`` places them with ``shard_fn`` wherever the new job
  runs, on a new mesh through ``distribute_params``.

The port writes its own format, which the reference's checkpoints are
not: ``state.pt``, a tree of plain dictionaries, lists and detached CPU
tensors written by ``torch.save`` (bfloat16 included, which needs no
``ml_dtypes``) and read back with ``torch.load(weights_only=True)``.  A
``NamedTuple`` in the saved state (``TrainState``, the optimizer states)
is stored as the dictionary of its fields.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Optional

import torch


def snapshot(tree: Any) -> Any:
    """A plain copy of ``tree`` on the host: every tensor detached and
    copied to the CPU, a ``NamedTuple`` as a dictionary, a tuple as a
    list."""
    if torch.is_tensor(tree):
        if hasattr(tree, "full_tensor"):  # a DTensor: its whole value
            tree = tree.full_tensor()
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, tuple) and hasattr(tree, "_asdict"):
        return {k: snapshot(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [snapshot(v) for v in tree]
    return tree


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any) -> str:
        self.wait()  # one writer at a time
        return self._write(step, snapshot(state))

    def save_async(self, step: int, state: Any) -> None:
        self.wait()  # one in flight
        host_state = snapshot(state)

        def write():
            try:
                self._write(step, host_state)
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the write in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, host_state: Any) -> str:
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        torch.save(host_state, os.path.join(tmp, "state.pt"))
        with open(os.path.join(tmp, "meta.json"), "w") as fh:
            json.dump({"step": step}, fh)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(os.path.join(self.dir, "LATEST.tmp"), "w") as fh:
            fh.write(str(step))
        os.replace(os.path.join(self.dir, "LATEST.tmp"),
                   os.path.join(self.dir, "LATEST"))
        self._gc()
        return final

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for n in os.listdir(self.dir):
            if n.startswith("step_") and not n.endswith(".tmp"):
                out.append(int(n.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.dir, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as fh:
            return int(fh.read().strip())

    def restore(self, step: Optional[int] = None,
                shard_fn: Optional[Callable[[Any], Any]] = None) -> Any:
        """Load a step (default: LATEST) as a tree of CPU tensors.
        ``shard_fn`` places it where the *current* job runs, e.g. a map
        of ``.to(device)`` over the tree, or on a new mesh (an elastic
        restart): ``lambda t: distribute_params(t, cfg, mesh, fsdp)``
        with :func:`repro_torch.launch.mesh.distribute_params` and the
        mesh of :func:`repro_torch.train.fault.remesh`."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        state = torch.load(os.path.join(self.dir, f"step_{step}",
                                        "state.pt"), weights_only=True)
        return shard_fn(state) if shard_fn else state
