"""Device mirrors of host numpy columns, keyed on identity, shape and version.

Counterpart of ``DeviceColumnCache`` in ``crane_scheduler_tpu/parallel/
sharded.py``, for one device. The drip batch kernel (``scorer.drip_batch``)
dispatches against the same cluster columns for many windows in a row;
re-uploading 50k-node columns per window would cost more than the window.
Column rebuilds always replace the host arrays (``framework.drip`` never
resizes in place), so object identity plus the caller's version is a sound
cache key. The slot pins the host array, so an ``id()`` cannot be recycled
while its key is live. ``prepare`` (e.g. a dtype cast) runs only on upload.

Every upload copies, also on the CPU, so a device column never aliases the
host array it mirrors. A column patched in place between two versions
(``DripColumns._patch_dynamic``, driven by the dirty-name journal) passes
``delta_rows``: the device copy is then patched with one exact-row
``index_copy`` into a new tensor, never in place, since an earlier
window's work may still read the old one.

A column tiled over a node mesh (the shard-parallel drip window) is put
with ``place=``, which turns the prepared host array into its per-tile
device tensors; such a column is re-uploaded on a version change, never
patched, as in the reference. ``set_partition`` fences the cache to one
partitioning and names the device its single-device columns go to (for a
tiled one, the first tile's): a changed token drops every slot.
"""

from __future__ import annotations

import numpy as np
import torch

SINGLE_DEVICE = ("single",)


def upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A private device copy of ``host`` (never a view of its memory). On
    CUDA it goes through a pinned staging copy, non-blocking: the host
    does not wait for it (a pageable copy would synchronise the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if device.type == "cpu":
        return t.clone()
    return t.pin_memory().to(device, non_blocking=True)


class DeviceColumnCache:
    def __init__(self, device: torch.device):
        self._device = device
        self._slots: dict[str, tuple] = {}
        self.uploads = 0
        self.scatters = 0  # delta-row device patches (avoided uploads)
        # the partitioning the slots are placed for: a resized mesh must
        # never serve columns tiled for the old one
        self._partition_token = None
        self.repartitions = 0

    @property
    def device(self) -> torch.device:
        """Where single-device columns are uploaded (``set_partition``)."""
        return self._device

    def set_partition(self, token, device: torch.device) -> bool:
        """Declare the partitioning the cached columns are placed for (any
        token that compares by value: ``SINGLE_DEVICE`` or a mesh's
        ``token()``) and the device of its single-device columns. Returns
        True (and drops every slot) when the token changed from an earlier
        one."""
        self._device = device
        if token == self._partition_token:
            return False
        changed = self._partition_token is not None
        self._partition_token = token
        if changed:
            self._slots.clear()
            self.repartitions += 1
        return changed

    def held_version(self, name: str, arr):
        """The version the cached slot for ``name`` holds, or None when the
        slot is absent or keyed to a different array object — the input
        for ``DripColumns.dirty_rows_between`` when building a
        ``delta_rows`` scatter."""
        slot = self._slots.get(name)
        if slot is None:
            return None
        key = slot[0]
        if key[0] != id(arr) or key[1] != arr.shape:
            return None
        return key[2]

    def put(self, name: str, arr: np.ndarray, version=0, prepare=None,
            delta_rows=None, row_prepare=None, place=None):
        """Device tensor for ``arr``, uploading only when the ``(identity,
        shape, version)`` key changed since the last call.

        ``delta_rows`` (int array) declares that the held slot differs
        from ``arr`` only at those rows (the same array object, patched in
        place between the held version and ``version``): the device copy
        is then patched by one ``index_copy`` of those rows into a new
        tensor instead of a full upload. An empty delta keeps the held
        tensor. ``row_prepare`` is the elementwise (dtype) half of
        ``prepare``, applied to the scattered rows. ``place`` (the prepared
        host array -> its device value, e.g. per-tile tensors) replaces the
        single-device upload and rules the scatter out."""
        key = (id(arr), arr.shape, version)
        slot = self._slots.get(name)
        if slot is not None and slot[0] == key:
            return slot[1]
        if (
            delta_rows is not None
            and place is None
            and slot is not None
            and slot[0][0] == id(arr)
            and slot[0][1] == arr.shape
        ):
            if len(delta_rows) == 0:
                dev = slot[1]
            else:
                rows = np.asarray(delta_rows, dtype=np.int64)
                vals = arr[rows]
                if row_prepare is not None:
                    vals = row_prepare(vals)
                dev = slot[1].index_copy(
                    0, upload(rows, self._device), upload(vals, self._device)
                )
            self._slots[name] = (key, dev, arr)
            self.scatters += 1
            return dev
        host = arr if prepare is None else prepare(arr)
        dev = upload(host, self._device) if place is None else place(host)
        self._slots[name] = (key, dev, arr)
        self.uploads += 1
        return dev

    def drop(self, name: str | None = None) -> None:
        if name is None:
            self._slots.clear()
        else:
            self._slots.pop(name, None)
