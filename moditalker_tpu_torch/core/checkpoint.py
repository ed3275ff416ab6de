"""Checkpoints in the port's own format (the interface of
``moditalker_tpu/core/checkpoint.py``; ref AToM/AToM.py:188-196 and
MToV/tools/trainer.py:122-124, 251-257).

A train state is one tree: a dict of tensors, state_dicts, optimizer
state_dicts and plain numbers. ``CheckpointManager`` writes it with
``torch.save`` into one directory per step, ``<directory>/<step>/state.pt``;
the step's directory appears by one rename once the file is complete, so a
crash never leaves a half-written step behind. A save copies the tree to
host memory before it returns and, unless ``blocking``, writes it on a
thread: ``wait()`` is the durability barrier (the fit loops call it at
exit), and ``restore`` and ``latest_step`` wait first. ``save_single`` /
``load_single`` write and read one tree as one file (exports, EMA-only
weights, the AE weights ``train-diffusion`` reads).

The JAX package's orbax directories are not read here.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any

import torch

STATE_FILE = "state.pt"


def host_tree(tree: Any):
    """A copy of ``tree`` with every tensor detached and copied to the host
    (so a later in-place update of the live state cannot reach the save)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_tree(v) for v in tree)
    return tree


def _check_template(tree: dict, template: dict, where: str = "") -> None:
    if set(tree) != set(template):
        raise KeyError(f"checkpoint keys {sorted(tree)} at {where or '/'} "
                       f"differ from the template's {sorted(template)}")
    for k, v in template.items():
        if isinstance(v, dict) and isinstance(tree[k], dict):
            _check_template(tree[k], v, f"{where}/{k}")


class CheckpointManager:
    """One directory per saved step, the newest ``max_to_keep`` kept (all of
    them where it is None or 0)."""

    def __init__(self, directory: str, max_to_keep: int | None = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._pending: list[threading.Thread] = []
        self._errors: list[BaseException] = []

    def _steps(self) -> list[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit()
                      and os.path.isfile(os.path.join(self.directory, d,
                                                      STATE_FILE)))

    def _write(self, step: int, tree) -> None:
        final = os.path.join(self.directory, str(step))
        tmp = f"{final}.tmp-{os.getpid()}-{threading.get_ident()}"
        os.makedirs(tmp, exist_ok=True)
        torch.save(tree, os.path.join(tmp, STATE_FILE))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        if self.max_to_keep:
            for old in self._steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)),
                              ignore_errors=True)

    def _write_after(self, prev: threading.Thread | None, step: int,
                     tree) -> None:
        if prev is not None:   # saves land in the order they were made
            prev.join()
        try:
            self._write(step, tree)
        except BaseException as e:   # re-raised by wait()
            self._errors.append(e)

    def save(self, step: int, state: Any, blocking: bool = False):
        """Snapshot ``state`` to host memory now; write it on a thread, or
        before returning where ``blocking``."""
        tree = host_tree(state)
        if blocking:
            self.wait()
            self._write(step, tree)
            return
        prev = self._pending[-1] if self._pending else None
        th = threading.Thread(target=self._write_after,
                              args=(prev, step, tree), daemon=False)
        th.start()
        self._pending.append(th)

    def wait(self):
        """Block until every pending save is on disk; re-raise a failed
        one."""
        while self._pending:
            self._pending.pop(0).join()
        if self._errors:
            err, self._errors = self._errors[0], []
            raise err

    def restore(self, step: int | None = None, template: Any = None):
        """The tree saved at ``step`` (default: the latest), tensors on the
        host; None where nothing was saved. A ``template`` dict must have
        the same keys (checked recursively through nested dicts)."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        tree = torch.load(os.path.join(self.directory, str(step), STATE_FILE),
                          map_location="cpu", weights_only=True)
        if template is not None:
            _check_template(tree, template)
        return tree

    def latest_step(self) -> int | None:
        self.wait()
        steps = self._steps()
        return steps[-1] if steps else None

    def close(self):
        self.wait()


def save_single(path: str, tree: Any):
    """One tree as one file (``torch.save`` of its host copy)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    torch.save(host_tree(tree), tmp)
    os.replace(tmp, path)


def load_single(path: str):
    return torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)
