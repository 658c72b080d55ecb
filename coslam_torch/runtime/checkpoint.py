"""Checkpoint save/load: model params, pose tables and resume state.

Counterpart of coslam_tpu/runtime/checkpoint.py (the ``.npz`` backend),
with the same file keys:

- ``leaf_i``: the parameter tensors in the JAX package's sorted-key
  flatten order (``param_leaves``: ``decoder.color_net[*]``, then
  ``decoder.sdf_net[*]``, with ActiveCoSLAM's linear heads at their
  sorted places among them, each ``b`` before ``w``, then the grid, a
  dict grid's tables in sorted-key order (TensoVM's ``lines`` before its
  ``planes``, TriPlaneHybrid's ``dense`` before its ``planes``), then
  the color grid under ``oneGrid: false``), and ``n_leaves``;
- ``pose`` (the absolute pose table), ``pose_rel_keys`` and
  ``pose_rel_vals`` (the keyframe-relative poses);
- ``extra_<k>`` for an array of the resume state, and ``exn_<k>`` with
  ``exleaf_<k>_<i>`` for a list of arrays (a pytree on the JAX side, such
  as the optimizer state, whose leaves come in JAX's flatten order).

A JAX file also holds ``treedef`` and an ``extree_<k>`` for each pytree
extra: pickled JAX objects. The loader here reads neither (the arrays
are opened with ``allow_pickle=False``): it finds the pytree extras by
their ``exn_<k>`` keys and rebuilds the parameter structure from the
port's own parameter dict. The port writes no ``treedef`` and no
``extree_<k>``, so the JAX package's ``load_ckpt``, which needs them,
does not read the port's checkpoints; the port reads the JAX package's.

Writes are atomic (a ``.tmp`` file, then ``os.replace``) and uncompressed,
so a crash mid-write leaves the previous checkpoint whole.
:class:`AsyncCheckpointWriter` moves the device-to-host copies and the
write off the frame loop: at submit it clones every tensor it is given on
the device (the next Adam step updates the parameters and moments in
place), records an event after the clones, and its thread waits on that
event before copying to the host. The orbax backend of the JAX package
(a ``.orbax`` path) is not ported.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..convert import label_leaves, map_opt_labels


def param_leaves(params: Dict) -> List:
    """The parameters in the JAX package's sorted-key flatten order, the
    optax labels' leaves label by label: ``decoder`` (``color_net`` then
    ``sdf_net``) before ``grid`` before ``grid_color``, a dict grid's
    tables in sorted-key order."""
    return [p for label in map_opt_labels(params)
            for p in label_leaves(params, label)]


def _is_tree(v) -> bool:
    return isinstance(v, (list, tuple))


def _to_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _build_payload(params: Dict, est_c2w, est_c2w_rel: Dict[int, np.ndarray],
                   extra: Dict = None) -> Dict[str, np.ndarray]:
    """Flatten everything into {file key: ndarray} (the module docstring's
    keys). ``params`` and the values of ``extra`` may hold tensors or
    arrays; a list value of ``extra`` is a pytree extra."""
    leaves = param_leaves(params)
    keys = sorted(est_c2w_rel)
    payload = {
        "n_leaves": np.int64(len(leaves)),
        "pose": _to_numpy(est_c2w),
        "pose_rel_keys": np.array(keys, np.int64),
        "pose_rel_vals": (np.stack([_to_numpy(est_c2w_rel[k]) for k in keys])
                          if keys else np.zeros((0, 4, 4), np.float32)),
    }
    for i, leaf in enumerate(leaves):
        payload[f"leaf_{i}"] = _to_numpy(leaf)
    for k, v in (extra or {}).items():
        if _is_tree(v):
            payload[f"exn_{k}"] = np.int64(len(v))
            for i, leaf in enumerate(v):
                payload[f"exleaf_{k}_{i}"] = _to_numpy(leaf)
        else:
            payload[f"extra_{k}"] = _to_numpy(v)
    return payload


def _parse_payload(data) -> Tuple[List[np.ndarray], np.ndarray,
                                  Dict[int, np.ndarray], Dict]:
    """Inverse of _build_payload, for the port's files and the JAX
    package's: (parameter leaves in file order, est_c2w, est_c2w_rel,
    extra), each pytree extra a list of its leaves. ``treedef`` and
    ``extree_*`` are not read."""
    leaves = [np.asarray(data[f"leaf_{i}"])
              for i in range(int(data["n_leaves"]))]
    est_c2w = np.asarray(data["pose"])
    rel = {int(k): np.asarray(v) for k, v in zip(data["pose_rel_keys"],
                                                 data["pose_rel_vals"])}
    extra: Dict = {}
    for name in data.keys():
        if name.startswith("extra_"):
            extra[name[len("extra_"):]] = np.asarray(data[name])
        elif name.startswith("exn_"):
            k = name[len("exn_"):]
            extra[k] = [np.asarray(data[f"exleaf_{k}_{i}"])
                        for i in range(int(data[name]))]
    return leaves, est_c2w, rel, extra


def params_from_leaves(like: Dict, leaves: List[np.ndarray]) -> Dict:
    """A parameter dict of ``like``'s structure (the port's own) holding
    ``leaves`` (file order) as numpy arrays; raises on a count or shape
    that does not match."""
    want = param_leaves(like)
    if len(leaves) != len(want):
        raise ValueError(f"checkpoint has {len(leaves)} parameter leaves, "
                         f"the model {len(want)}")
    for got, ref in zip(leaves, want):
        if tuple(got.shape) != tuple(ref.shape):
            raise ValueError(f"checkpoint leaf {tuple(got.shape)} does not "
                             f"match the model's {tuple(ref.shape)}")
    out = {"decoder": {}}
    i = 0
    for k, v in sorted(like["decoder"].items()):
        if isinstance(v, dict):      # a linear head: b, w
            out["decoder"][k] = dict(zip(sorted(v), leaves[i:i + len(v)]))
        else:
            out["decoder"][k] = list(leaves[i:i + len(v)])
        i += len(v)
    for label in map_opt_labels(like)[1:]:
        grid = like[label]
        k = len(grid) if isinstance(grid, dict) else 1
        out[label] = (dict(zip(sorted(grid), leaves[i:i + k]))
                      if isinstance(grid, dict) else leaves[i])
        i += k
    return out


def save_ckpt(path: str, params: Dict, est_c2w, est_c2w_rel: Dict,
              extra: Dict = None) -> None:
    """Write the checkpoint at ``path`` atomically, uncompressed (resume
    checkpoints carry the keyframe ray reservoir)."""
    if path.endswith(".orbax"):
        raise NotImplementedError("the .orbax checkpoint backend is not "
                                  "ported; write a .npz path")
    payload = _build_payload(params, est_c2w, est_c2w_rel, extra)
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # a handle: savez must not append .npz
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_ckpt(path: str, like: Dict) -> Tuple[Dict, np.ndarray,
                                              Dict[int, np.ndarray], Dict]:
    """(params as numpy arrays in ``like``'s structure, est_c2w,
    est_c2w_rel, extra) from a ``.npz`` written by the port or by the JAX
    package."""
    if path.endswith(".orbax") or os.path.isdir(path):
        raise NotImplementedError("the .orbax checkpoint backend is not "
                                  "ported; load a .npz path")
    with np.load(path, allow_pickle=False) as data:
        leaves, est, rel, extra = _parse_payload(data)
    return params_from_leaves(like, leaves), est, rel, extra


class SingleFlightWorker:
    """Run thunks on a background thread, at most one in flight.

    ``submit`` first joins any previous job (jobs land in submission
    order and at most one job's buffers are alive); ``wait`` joins and
    re-raises any exception of the job. The caller owns snapshot
    semantics: what the job reads must not change after submit."""

    def __init__(self, name: str = "bg-worker"):
        self._name = name
        self._thread: threading.Thread = None
        self._exc: BaseException = None

    def submit(self, fn, *args, **kwargs) -> None:
        self.wait()

        def _run():
            try:
                fn(*args, **kwargs)
            except BaseException as e:  # surfaced at the next wait()
                self._exc = e

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name=self._name)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc


def _clone(v):
    """Every tensor in v (dicts and lists walked) cloned on its device;
    numpy arrays copied."""
    if isinstance(v, torch.Tensor):
        return v.detach().clone()
    if isinstance(v, dict):
        return {k: _clone(x) for k, x in v.items()}
    if _is_tree(v):
        return [_clone(x) for x in v]
    return np.array(v, copy=True)


class AsyncCheckpointWriter(SingleFlightWorker):
    """Background checkpoint writer. ``submit`` snapshots its arguments on
    the caller's thread (device clones, host copies) and records a CUDA
    event after the clones; the worker thread waits on the event, copies
    to the host and writes. So the file holds the state as of submit,
    however the caller updates its tensors in place afterwards; with
    save_ckpt's atomic rename, a crash leaves the newest completed
    checkpoint loadable."""

    def __init__(self):
        super().__init__(name="ckpt-writer")

    def submit(self, path: str, params: Dict, est_c2w, est_c2w_rel: Dict,
               extra: Dict = None) -> None:
        snap = _clone((params, est_c2w, est_c2w_rel, extra or {}))
        event = None
        devices = {t.device for t in _tensors(snap) if t.is_cuda}
        if len(devices) > 1:
            raise ValueError("checkpoint tensors on more than one card")
        if devices:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(devices.pop()))

        def write():
            if event is not None:
                event.synchronize()
            save_ckpt(path, *snap)

        super().submit(write)


def _tensors(v):
    if isinstance(v, torch.Tensor):
        yield v
    elif isinstance(v, dict):
        for x in v.values():
            yield from _tensors(x)
    elif _is_tree(v):
        for x in v:
            yield from _tensors(x)
