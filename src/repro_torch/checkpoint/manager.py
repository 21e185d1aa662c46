"""CheckpointManager: async writes and retention (the twin of the JAX
package's ``checkpoint/manager.py``, for one device).

- ``save(step, tree, meta)`` pins the tree before it returns, then writes
  it on a background thread, so the train loop does not wait on the disk.
  ``snapshot="host"`` copies the tree to the host first;
  ``snapshot="device"`` makes one device-to-device copy on the current
  stream and leaves the device-to-host copy to the writer thread. Either
  way a tensor the caller changes in place after ``save`` returns is
  written as it was at the call.
- retention: the newest ``keep`` checkpoints stay.
- ``restore(step, template)`` loads into the template's devices and
  dtypes.
"""
from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.checkpoint import io

Params = Any


def _zip_map(fn, tree, other):
    """``fn(leaf, other_leaf)`` over two trees of dicts and NamedTuples of
    one structure."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(fn, a, b) for a, b in zip(tree, other)))
    return fn(tree, other)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Params, meta: Optional[Dict] = None,
             *, block: bool = False, snapshot: str = "host") -> None:
        """Write ``tree`` as step ``step`` (one write in flight at a time).

        ``snapshot="host"``: the device-to-host copy happens here, so the
        caller may change or free the tree once ``save`` returns.
        ``snapshot="device"``: a device copy is queued on the current stream
        (ordered before any later kernel that writes the source tensors)
        and the writer thread copies it to the host, so the caller resumes
        at once.
        """
        if snapshot not in ("host", "device"):
            raise ValueError(f"snapshot must be 'host' or 'device', got "
                             f"{snapshot!r}")
        self.wait()
        if snapshot == "device":
            snap = _zip_map(lambda t, _: (t.detach().clone()
                                          if isinstance(t, torch.Tensor)
                                          else t), tree, tree)
            stream = (torch.cuda.current_stream()
                      if torch.cuda.is_initialized() else None)

            def payload():
                if stream is not None:
                    stream.synchronize()
                return io.flatten_tree(snap)
        else:
            host_flat = io.flatten_tree(tree)

            def payload():
                return host_flat

        def write():
            try:
                io.save_step(self.dir, step, payload(), meta)
                for s in io.list_steps(self.dir)[:-self.keep]:
                    shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                                  ignore_errors=True)
            except BaseException as e:    # raised by the next wait()
                self._error = e

        if self.async_write and not block:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
            self.wait()

    def wait(self) -> None:
        """Join the write in flight; raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = io.list_steps(self.dir)
        return steps[-1] if steps else None

    def latest_meta(self) -> Optional[Dict]:
        """Meta dict of the newest checkpoint, arrays not read."""
        step = self.latest_step()
        if step is None:
            return None
        return io.load_meta(self.dir, step)

    def restore(self, step: int, template: Params, device=None
                ) -> Tuple[Params, Dict]:
        """``(tree, meta)``: each leaf in its template leaf's dtype, on
        ``device`` (the port's stand-in for the JAX package's target
        shardings) or else on the template leaf's device. A template may
        live on the ``meta`` device (shapes and dtypes only)."""
        flat, meta = io.load_step(self.dir, step)
        tree = io.unflatten_into(template, flat)

        def place(arr, t):
            if not isinstance(t, torch.Tensor):
                return arr
            dev = device if device is not None else t.device
            return arr.to(device=dev, dtype=t.dtype)
        return _zip_map(place, tree, template), meta

    def restore_latest(self, template: Params, device=None
                       ) -> Optional[Tuple[Params, Dict]]:
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(step, template, device)

