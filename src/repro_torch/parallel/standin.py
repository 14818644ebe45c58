"""A mesh of ranks in one process: the stand-in for a process group.

:class:`StandInMesh` has the attributes of a ``DeviceMesh`` that the
sharding rules read (axis names, shape, this rank's coordinate) and runs
one thread a rank (:meth:`StandInMesh.run`).  The ranks run the same
code in lockstep: each collective of ``parallel.collectives`` posts the
rank's tensor, waits for every rank of its group at a barrier, and
combines the posted tensors in rank order.  One rank runs at a time
between two collectives (it holds a baton that it hands on while it
waits at a barrier): PyTorch lets go of the interpreter lock in every
op, and ranks that ran at once would hand it to each other at every op
(on an H100, granite-moe-1b-a400m's decode step over 4 model ranks took
1,066 ms so, 17 times one device's).  It opens no process group, socket
or subprocess, and every wait is bounded: a rank that fails breaks the
barriers, so the others raise instead of waiting.

A sum, and a gather of a sequence's runs (``collectives.mesh_cat``),
keep the autograd edges of every rank's contribution: the ranks' graphs
join into one, and one ``backward`` of the sum of every rank's
loss (in the caller's thread, after :meth:`run`) gives each rank's
leaves the gradients a process group's ranks get from the same step,
where a sum's backward sums the ranks' gradients and a gather's
reduce-scatters them.  So training needs no
collective in the backward, and no recompute: the stand-in runs under
the ``"none"`` remat policy.
"""
from __future__ import annotations

import itertools
import threading

import torch

#: Seconds a rank may wait at a barrier for the others.
BARRIER_TIMEOUT_S = 120.0


class _Group:
    """The exchange of one group: a barrier and two rows of one slot a
    member, used in turn, so that one wait a collective suffices (a rank
    posts its next value into the other row while a slower one may still
    read this one; it cannot come back to this row before the slower
    one has reached the next barrier)."""

    def __init__(self, n: int, timeout: float):
        self.barrier = threading.Barrier(n, timeout=timeout)
        self.slots: list = [[None] * n, [None] * n]
        self.turns = [0] * n


class StandInMesh:
    """``shape`` ranks over the axes ``names`` (outermost first), one
    thread each while :meth:`run` runs; tensors lie on ``device_type``."""

    def __init__(self, shape, names=("data", "model"), device_type="cpu",
                 timeout: float = BARRIER_TIMEOUT_S):
        self.shape = tuple(int(n) for n in shape)
        self.mesh_dim_names = tuple(names)
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"shape {self.shape} and axes "
                             f"{self.mesh_dim_names} differ in length")
        self.ndim = len(self.shape)
        self.device_type = device_type
        self.timeout = timeout
        self._local = threading.local()
        self._lock = threading.Lock()
        self._groups: dict = {}
        self._broken = False
        self._baton = threading.Lock()   # held by the rank that runs

    def coords(self) -> list[tuple[int, ...]]:
        """Every rank's coordinate, row-major."""
        return list(itertools.product(*(range(n) for n in self.shape)))

    def get_coordinate(self) -> list[int]:
        coord = getattr(self._local, "coord", None)
        if coord is None:
            raise RuntimeError("a stand-in mesh has a coordinate only on "
                               "the threads of StandInMesh.run")
        return list(coord)

    def run(self, fn) -> dict:
        """``{coord: fn(coord)}``, each rank on a thread of its own (grad
        mode as the caller's); the first rank's error is raised once every
        thread has ended."""
        self._groups, self._broken = {}, False
        grad = torch.is_grad_enabled()
        results, errors = {}, {}

        def body(coord):
            self._local.coord = coord
            self._baton.acquire()
            try:
                with torch.set_grad_enabled(grad):
                    results[coord] = fn(coord)
            except BaseException as e:   # noqa: BLE001  (re-raised below)
                errors[coord] = e
                self._abort()
            finally:
                self._baton.release()

        threads = [threading.Thread(target=body, args=(c,), daemon=True,
                                    name=f"rank{c}") for c in self.coords()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            real = [e for e in errors.values()
                    if not isinstance(e, threading.BrokenBarrierError)]
            raise (real or list(errors.values()))[0]
        return results

    def _abort(self) -> None:
        with self._lock:
            self._broken = True
            for g in self._groups.values():
                g.barrier.abort()

    def exchange(self, dims, value) -> list:
        """The ``value`` of every rank of this rank's group along the
        mesh ``dims`` (the ranks that share its coordinate on the other
        dims), in their order on ``dims`` (row-major, the first dim
        outermost)."""
        coord = tuple(self.get_coordinate())
        dims = tuple(sorted(dims))
        key = (dims, tuple(c for d, c in enumerate(coord) if d not in dims))
        n = 1
        for d in dims:
            n *= self.shape[d]
        with self._lock:
            group = self._groups.get(key)
            if group is None:
                group = self._groups[key] = _Group(n, self.timeout)
                if self._broken:   # a rank failed before this group began
                    group.barrier.abort()
        i = 0
        for d in dims:
            i = i * self.shape[d] + coord[d]
        row = group.slots[group.turns[i] % 2]
        group.turns[i] += 1
        row[i] = value
        self._baton.release()   # the next rank runs while this one waits
        try:
            self._wait(group)
        finally:
            self._baton.acquire()
        return list(row)

    def _wait(self, group: _Group) -> None:
        try:
            group.barrier.wait()
        except threading.BrokenBarrierError:
            raise threading.BrokenBarrierError(
                f"stand-in rank {self.get_coordinate()}: a rank failed or "
                f"waited over {self.timeout} s at a collective") from None
