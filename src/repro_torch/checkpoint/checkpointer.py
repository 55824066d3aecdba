"""Async, restart-safe checkpoints in the JAX package's on-disk layout
(counterpart of ``repro.checkpoint.checkpointer``, chip scope).

Layout (one directory per step), the JAX package's::

    <dir>/step_000100/
        manifest.json      # step, and per leaf its path, file, dtype and
                           # shape
        leaf_00000.npy ... # one .npy per leaf
    <dir>/LATEST           # atomic pointer (tmp+rename)

Leaves come in the JAX package's order under its paths
(``jax.tree_util.keystr``: ``.params['layers']['attn']['wq']``), so a
checkpoint moves between the two packages in both directions.  The port
keeps a list of per-layer dicts where the JAX package stacks every layer
leaf along a leading ``num_layers`` dim, and a list of such lists (the
hybrid's ``groups``) where it stacks along two, (ngroups, attn_every):
``save`` stacks them and ``restore`` takes them apart again.  A bf16
leaf is written as the JAX
package writes it: raw 2-byte values under the ``.npy`` descr ``<V2`` with
``"dtype": "bfloat16"`` in the manifest; ``restore`` reads it by the
manifest's dtype.  ``restore`` casts each leaf to the template's dtype and
puts it on the template leaf's device.

Fault-tolerance contract, as in the JAX package: a step directory is
written under ``.tmp-...`` and renamed into place, then LATEST is swapped,
so a crash mid-save never corrupts the restore point; ``save_async``
copies the tree to host memory at once and writes it in a background
thread; the newest ``keep`` checkpoints are kept.

Elastic restore, as in the JAX package: ``save(..., specs=)`` writes the
logical PartitionSpecs (axis names, no device ids) into the manifest, one
string per leaf (``str(spec)``, the reference's strings: a tree of the
stacked specs, ``distributed.partition``'s ``stacked=True``, whose layer
lists are collapsed into dicts); ``restore(..., shardings=)`` takes a
NamedSharding tree in the template's structure, built for the *current*
mesh (which may differ from the saver's), and each rank keeps its own
tile of every leaf, over the data axes and over ``model`` alike (the
trainer's shards of the leaves the model axis splits), in storage laid
out as a whole leaf's.  The mesh trainer hands ``save`` the parameters and
moments whole and lets one rank write.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.sharding import PartitionSpec
from repro_torch.utils.tree import tree_paths

__all__ = ["Checkpointer"]

Pytree = Any

#: The .npy descr the JAX package's bfloat16 leaves carry (ml_dtypes'
#: bfloat16 is a 2-byte void type to numpy).
_BF16_DESCR = "<V2"


def _is_layer_list(x) -> bool:
    """A non-empty list of per-layer dicts, or of such lists (a stack of
    stacks, as the hybrid's ``groups``)."""
    return isinstance(x, list) and bool(x) and (
        all(isinstance(e, dict) for e in x)
        or all(_is_layer_list(e) for e in x))


def _paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(path, leaf)]`` in the JAX package's leaf order, where a list of
    per-layer dicts counts as one dict of stacked leaves: its entries are
    ``(path, [layer 0's leaf, layer 1's, ...])``, and a list of such lists
    ``(path, [[group 0 layer 0's leaf, ...], ...])``."""
    if tree is None:
        return []
    if isinstance(tree, PartitionSpec):
        return [(prefix, tree)]
    if _is_layer_list(tree):
        layers = [_paths(x) if isinstance(x, list) else tree_paths(x)
                  for x in tree]
        return [(prefix + p, [lay[j][1] for lay in layers])
                for j, (p, _) in enumerate(layers[0])]
    if isinstance(tree, dict):
        return [e for k in sorted(tree)
                for e in _paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [e for f in tree._fields
                for e in _paths(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [e for i, x in enumerate(tree)
                for e in _paths(x, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _stack(leaf) -> torch.Tensor:
    """A leaf on the host; a (nested) list of layers' leaves stacked, one
    leading dim a level."""
    if isinstance(leaf, list):
        return torch.stack([_stack(x) for x in leaf])
    return torch.as_tensor(leaf).detach().cpu()


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(array, manifest dtype) of a leaf; a list of layers is stacked."""
    t = _stack(leaf)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _save_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _load_leaf(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _rebuild(tree, prefix: str, get, layer: Optional[tuple] = None,
             shard=None):
    """``tree``'s structure with each leaf replaced by ``get(path)`` (entry
    ``layer`` of it, an index a stacked dim, inside a list of layers), in
    the leaf's dtype and on its device; ``shard``, a NamedSharding tree of
    the same structure (or None), cuts each leaf to this rank's tile."""
    if tree is None:
        return None
    if layer is None and _is_layer_list(tree):
        return _rebuild_layers(tree, prefix, get, (), shard)
    if isinstance(tree, dict):
        return {k: _rebuild(v, f"{prefix}[{k!r}]", get, layer,
                            None if shard is None else shard[k])
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), f"{prefix}.{f}",
                                     get, layer,
                                     None if shard is None
                                     else getattr(shard, f))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, f"{prefix}[{i}]", get, layer,
                                   None if shard is None else shard[i])
                          for i, x in enumerate(tree))
    t = get(prefix)
    if layer is not None:
        t = t[layer]
    if shard is not None:
        from repro_torch.distributed.sharding import local_slice
        t = local_slice(t, shard).contiguous()
    return t.to(device=tree.device, dtype=tree.dtype)


def _rebuild_layers(tree: list, prefix: str, get, index: tuple,
                    shard=None) -> list:
    """A layer list (or a list of them) rebuilt from the stacked leaves:
    entry i of the list at ``index`` takes index + (i,)."""
    return [_rebuild_layers(x, prefix, get, index + (i,),
                            None if shard is None else shard[i])
            if isinstance(x, list) else
            _rebuild(x, prefix, get, index + (i,),
                     None if shard is None else shard[i])
            for i, x in enumerate(tree)]


def _spec_strings(tree, specs) -> list:
    """``str(spec)`` of each leaf of ``tree`` in leaf order, from a spec
    tree over the same paths (the stacked one: layer lists collapsed)."""
    by_path = {p: s for p, s in _paths(specs)}
    want = [p for p, _ in _paths(tree)]
    if sorted(want) != sorted(by_path) or not all(
            isinstance(s, PartitionSpec) for s in by_path.values()):
        missing = sorted(set(want) - set(by_path))
        raise ValueError(f"the specs do not match the tree's leaves: "
                         f"missing {missing[:4]}")
    return [str(by_path[p]) for p in want]


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def latest_step(self) -> Optional[int]:
        ptr = os.path.join(self.dir, "LATEST")
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            return int(f.read().strip())

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.startswith(".tmp"):
                steps.append(int(name.split("_")[1]))
        return sorted(steps)

    # ------------------------------------------------------------------
    def _snapshot(self, tree: Pytree, specs) -> tuple[list, Optional[list]]:
        strings = None if specs is None else _spec_strings(tree, specs)
        return [(p, *_to_host(leaf)) for p, leaf in _paths(tree)], strings

    def save(self, step: int, tree: Pytree, *, specs: Pytree = None) -> None:
        """Blocking save.  ``specs``: an optional PartitionSpec tree to
        embed (module docstring)."""
        self._write(step, *self._snapshot(tree, specs))

    def save_async(self, step: int, tree: Pytree, *,
                   specs: Pytree = None) -> None:
        """Snapshot now (device -> host), write in the background."""
        self.wait()
        host, strings = self._snapshot(tree, specs)
        self._thread = threading.Thread(target=self._write,
                                        args=(step, host, strings),
                                        daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: list,
               specs: Optional[list] = None) -> None:
        final = self._step_dir(step)
        tmp = os.path.join(self.dir, f".tmp-{step:08d}-{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {
            "step": step,
            "leaves": [
                {"path": p, "file": f"leaf_{i:05d}.npy", "dtype": dt,
                 "shape": list(arr.shape)}
                for i, (p, arr, dt) in enumerate(host)
            ],
            "specs": specs,
        }
        for i, (_, arr, dt) in enumerate(host):
            _save_leaf(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr, dt)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic publish
        ptr_tmp = os.path.join(self.dir, ".LATEST.tmp")
        with open(ptr_tmp, "w") as f:
            f.write(str(step))
        os.rename(ptr_tmp, os.path.join(self.dir, "LATEST"))
        self._prune()

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, template: Pytree, *, step: Optional[int] = None,
                mesh=None, shardings: Pytree = None) -> Pytree:
        """Restore into the structure of ``template``: each leaf by its
        path, in the template leaf's dtype and on its device.
        ``shardings``: an optional NamedSharding tree in the template's
        structure, built for the current mesh; each leaf is cut to this
        rank's tile of it (the elastic re-mesh).  ``mesh`` names that mesh
        and is not read otherwise, as in the JAX package."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        entries = {e["path"]: e for e in manifest["leaves"]}
        want = [p for p, _ in _paths(template)]
        if sorted(want) != sorted(entries):
            missing = sorted(set(want) - set(entries))
            extra = sorted(set(entries) - set(want))
            raise ValueError(f"checkpoint step {step} does not match the "
                             f"template: missing {missing[:4]}, extra "
                             f"{extra[:4]}")
        loaded: dict = {}

        def get(path):
            if path not in loaded:
                e = entries[path]
                loaded[path] = _load_leaf(os.path.join(d, e["file"]),
                                          e["dtype"])
            return loaded[path]

        return _rebuild(template, "", get, shard=shardings)
