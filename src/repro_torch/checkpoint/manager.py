"""Fault-tolerant checkpointing: async, atomic, keep-k, restart-exact.

The PyTorch counterpart of ``repro.checkpoint.manager``, with its on-disk
layout, so either package reads the other's checkpoints:
  * a step is written into ``step_<n>.tmp/``, its manifest LAST, then
    renamed into place: a half-written checkpoint is never observable;
  * ``CheckpointManager.save`` copies the tensors to the host, then hands
    the writing to a background thread; ``wait()`` joins it;
  * keep-k pruning removes complete checkpoints only, and torn ``*.tmp``
    saves are removed when a manager starts;
  * leaves are stored by tree path (``params/blocks/attn/wq``) as ``.npy``,
    bf16 as 2-byte void records with ``"bfloat16"`` in the manifest (what
    the JAX package's ml_dtypes arrays give), and restored into a target
    tree of tensors on the target's devices;
  * ``ledger.npz`` beside the state holds the recycle ledger in the
    ``.npz`` interchange format of ``--ledger-out``;
  * the spans ``checkpoint.fetch`` (the host copies), ``checkpoint.save``
    (the write, on the save thread) and ``checkpoint.restore`` go to the
    installed telemetry (``repro_torch.obs.current``).

On a data axis of several ranks (``CheckpointManager(layout=)``)
saving is collective: every rank calls ``save``, the param slices that
the layout holds (FSDP) and the ZeRO-1 moment slices (``opt/m``,
``opt/v``) are gathered into full leaves, and rank 0 alone writes, so a
checkpoint keeps the one-device layout (readable by the JAX manager).
``restore`` cuts each held param leaf and each moment leaf to the
restoring rank's slice of its own layout, so a checkpoint resumes on any
number of ranks. On a mesh with a model axis the model cuts are gathered
too (after the data cuts) and taken again on restore (before them), so a
checkpoint of (2, 2) resumes on (1, 4), (4, 1) or one rank: the format
knows no layout.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.distributed.zero import HELD
from repro_torch.models.params import tree_map

LEDGER_FILE = "ledger.npz"
_BF16 = np.dtype("V2")
ZERO1_MOMENTS = ("m", "v")  # the optimizer-state leaves a ZeRO-1 layout cuts


def _writes(layout) -> bool:
    """Whether this process writes checkpoints: rank (0, 0) of the
    layout's (data, model) mesh where one is given, else rank 0 of the
    group, or a process outside any group."""
    if layout is not None:
        return layout.rank == 0 and layout.model_rank == 0
    return not dist.is_initialized() or dist.get_rank() == 0


def full_state(state: Any, layout) -> Any:
    """``state`` with its held param slices and its ZeRO-1 moment slices
    gathered into full leaves, over the data axis and then the model axis
    (a collective: every rank of the mesh calls it)."""
    opt = dict(state["opt"])
    for k in ZERO1_MOMENTS:
        if k in opt:
            opt[k] = layout.model_gather(layout.gather(opt[k]))
    return dict(state, params=layout.model_gather(
        layout.gather(state["params"], HELD)), opt=opt)


def state_cut(layout):
    """``cut(path, array)`` for ``load_checkpoint``: a full param leaf or
    moment leaf -> this rank's slice in ``layout`` (its model slice, then
    its data slice where the layout holds one); other leaves
    unchanged."""

    def cut(path: tuple, arr: np.ndarray) -> np.ndarray:
        if path[0] == "params":
            arr = layout.model_piece(arr, layout.model_dim_at(path[1:]))
            if layout.held_at(path[1:]):
                return layout.piece(arr, layout.dim_at(path[1:]))
            return arr
        if len(path) < 3 or path[0] != "opt" or path[1] not in ZERO1_MOMENTS:
            return arr
        arr = layout.model_piece(arr, layout.model_dim_at(path[2:]))
        return layout.piece(arr, layout.dim_at(path[2:]))

    return cut


def _key(path: tuple) -> str:
    return "/".join(map(str, path))


def _to_numpy(x) -> tuple[np.ndarray, str]:
    """(array to save, manifest dtype name). Tensors are copied: a save
    in flight must not see the optimizer update its moments in place."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(_BF16), "bfloat16"
        x = x.numpy()
    arr = np.asarray(x)
    return arr, str(arr.dtype)


def _flatten(tree: Any) -> dict[str, tuple[np.ndarray, str]]:
    flat = {}
    tree_map(lambda path, x: flat.__setitem__(_key(path), _to_numpy(x)), tree)
    return flat


def save_checkpoint(
    directory: str,
    step: int,
    state: Any,
    ledger: Optional[dict[str, np.ndarray]] = None,
) -> str:
    """Synchronous atomic save -> the checkpoint's path. ``ledger`` (a
    ledger state_dict) is written as ``ledger.npz`` under the same
    manifest-last atomicity."""
    return _write(directory, step, _flatten(state), ledger)


def _write(directory: str, step: int, flat: dict,
           ledger: Optional[dict[str, np.ndarray]]) -> str:
    with obs.span("checkpoint.save", cat="checkpoint", step=step):
        return _write_files(directory, step, flat, ledger)


def _write_files(directory, step, flat, ledger):
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": {}}
    for key, (arr, dtype) in flat.items():
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                   "dtype": dtype}
    if ledger is not None:
        np.savez(os.path.join(tmp, LEDGER_FILE), **ledger)
        manifest["ledger"] = LEDGER_FILE
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


def _is_complete(path: str) -> bool:
    mpath = os.path.join(path, "manifest.json")
    if not os.path.exists(mpath):
        return False
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        files = [leaf["file"] for leaf in manifest["leaves"].values()]
        if "ledger" in manifest:
            files.append(manifest["ledger"])
        return all(os.path.exists(os.path.join(path, f)) for f in files)
    except (json.JSONDecodeError, KeyError, OSError):
        return False


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(name[len("step_"):]) for name in os.listdir(directory)
        if name.startswith("step_") and not name.endswith(".tmp")
        and _is_complete(os.path.join(directory, name))
    ]
    return max(steps) if steps else None


def _from_numpy(arr: np.ndarray, dtype: str, like) -> Any:
    if isinstance(like, torch.Tensor):
        if dtype == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
            t = t.view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        return t.to(device=like.device, dtype=like.dtype)
    return arr


def load_checkpoint(directory: str, step: int, target: Any,
                    cut=None) -> Any:
    """Restore into ``target``'s structure: each tensor leaf comes back on
    the target leaf's device in its dtype; other leaves as numpy arrays.
    ``cut(path, array)``, where given, takes each stored array first (the
    rank's slice of a held param or a ZeRO-1 moment: ``state_cut``)."""
    path = os.path.join(directory, f"step_{step:010d}")
    with obs.span("checkpoint.restore", cat="checkpoint", step=step):
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)

        def leaf(p, like):
            meta = manifest["leaves"][_key(p)]
            arr = np.load(os.path.join(path, meta["file"]))
            if cut is not None:
                arr = cut(p, arr)
            return _from_numpy(arr, meta["dtype"], like)

        return tree_map(leaf, target)


def load_ledger(directory: str, step: int) -> Optional[dict[str, np.ndarray]]:
    """The checkpoint's ledger state_dict, or None if it carried none."""
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if "ledger" not in manifest:
        return None
    with np.load(os.path.join(path, manifest["ledger"])) as z:
        return dict(z)


class CheckpointManager:
    """Async keep-k checkpointing with torn-save garbage collection.

    ``layout`` (a ``distributed.zero.DataLayout``): the state's held
    params and moments are this rank's slices; ``save`` gathers them
    (every rank calls it) and rank 0 writes; ``restore`` cuts them to this
    rank's slices."""

    def __init__(self, directory: str, keep: int = 3, layout=None):
        self.directory = directory
        self.keep = keep
        self.layout = layout
        self.writes = _writes(layout)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)
        if not self.writes:
            return
        for name in os.listdir(directory):  # torn saves of a crash
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(directory, name),
                              ignore_errors=True)

    def save(
        self,
        step: int,
        state: Any,
        block: bool = False,
        ledger: Optional[dict[str, np.ndarray]] = None,
    ) -> None:
        """Fetch ``state`` (and snapshot ``ledger``) now, write it in the
        background; ``block`` waits for the write. With a layout a
        collective; a rank other than 0 writes nothing."""
        self.wait()  # one save in flight
        if self.layout is not None:
            state = full_state(state, self.layout)
        if not self.writes:
            return
        with obs.span("checkpoint.fetch", cat="checkpoint", step=step):
            flat = _flatten(state)  # host copies, before the thread runs
        if ledger is not None:
            # a host ledger keeps mutating its arrays while the thread runs
            ledger = {k: np.array(v) for k, v in ledger.items()}

        def work():
            try:
                _write(self.directory, step, flat, ledger)
                self._prune()
            except BaseException as e:  # raised again by the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if block:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _prune(self) -> None:
        steps = sorted(
            int(n[len("step_"):]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp")
            and _is_complete(os.path.join(self.directory, n))
        )
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    def latest(self) -> Optional[int]:
        return latest_step(self.directory)

    def restore(self, step: int, target: Any) -> Any:
        cut = None if self.layout is None else state_cut(self.layout)
        return load_checkpoint(self.directory, step, target, cut)

    def restore_ledger(self, step: int) -> Optional[dict[str, np.ndarray]]:
        return load_ledger(self.directory, step)
