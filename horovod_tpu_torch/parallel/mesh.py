"""Hybrid meshes: the dp × pp × ep × tp × sp axes over the job's ranks.

Counterpart of `horovod_tpu/parallel/mesh.py` (`AXIS_ORDER`,
`MeshConfig`, `create_hybrid_mesh`, `mesh_axis_size`, `batch_spec`; the
constants and checks are copied here, since the port imports nothing of
the JAX package).  Where the JAX package reshapes `jax.devices()` into
a named device mesh, a port mesh is this rank's coordinate on each axis
and one `ProcessSet` per axis: the ranks that share every other
coordinate.  Coordinates come from a row-major reshape of the ranks
0..n-1 over `AXIS_ORDER` (outermost first), as JAX reshapes its device
list, so rank r of a JAX test's mesh and rank r here hold the same
shards.

    mesh = create_hybrid_mesh(dp=-1, sp=2)     # every rank calls it
    mesh.shape["sp"], mesh.index("sp"), mesh.sets["sp"]

Axis conventions as in the JAX module: dcn (cross-slice data parallel:
in `make_train_step` it replicates the batch, as JAX's data spec leaves
it out), dp, pp (pipeline stages), ep (experts), tp (tensor parallel),
sp (sequence).

`create_hierarchical_mesh(dcn, ici)` is the two-tier data-parallel mesh
("dcn", "hvd") of `parallel/hierarchical.py`: pass it where the JAX
package passes the axis pair `("dcn", "hvd")` (`axis_name=` of
`DistributedOptimizer`, `reduce_gradient_buckets`,
`allreduce_gradients`, `zero3_placement`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

from ..common import basics
from ..common.basics import ProcessSet
from ..common.exceptions import HorovodTpuError

AXIS_ORDER = ("dcn", "dp", "pp", "ep", "tp", "sp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dcn: int = 1
    dp: int = 1
    pp: int = 1
    ep: int = 1
    tp: int = 1
    sp: int = 1

    def sizes(self) -> Tuple[int, ...]:
        return tuple(getattr(self, a) for a in AXIS_ORDER)

    def total(self) -> int:
        return math.prod(self.sizes())


@dataclasses.dataclass
class Mesh:
    """This rank's view of a hybrid mesh.

    shape: axis -> size (every axis of AXIS_ORDER); coords: axis -> this
    rank's coordinate; sets: axis -> the ProcessSet of the ranks that
    differ from this one only on that axis (a set of one rank, which
    exchanges nothing, where the axis has size 1); ranks: the global
    ranks in mesh order."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    sets: Dict[str, ProcessSet]
    ranks: Tuple[int, ...]
    axis_names: Tuple[str, ...] = AXIS_ORDER

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def on(self, axis: str) -> Optional[ProcessSet]:
        """The axis' set when the axis has more than one rank, else
        None (the shard body then skips the axis, as the JAX transformer
        passes `None` for an absent axis)."""
        return self.sets[axis] if self.shape[axis] > 1 else None


def _axis_sizes(n: int, sizes: Dict[str, int]) -> Dict[str, int]:
    wild = [a for a, s in sizes.items() if s == -1]
    if len(wild) > 1:
        raise HorovodTpuError("at most one mesh axis may be -1")
    if wild:
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if n % fixed:
            raise HorovodTpuError(
                f"{n} devices not divisible by fixed axes product {fixed}")
        sizes[wild[0]] = n // fixed
    if math.prod(sizes.values()) != n:
        raise HorovodTpuError(
            f"mesh {sizes} needs {math.prod(sizes.values())} devices, "
            f"have {n}")
    return sizes


def _axis_set(ranks: Sequence[int], size: int) -> ProcessSet:
    """The process set over `ranks`: the global set or one registered
    before when it holds the same ranks, a set of its own (no group,
    nothing to exchange) for one rank, else a new one.  Every rank makes
    the same choices, since every rank registers every set."""
    ranks = sorted(ranks)
    if size == 1:
        return ProcessSet(ranks=ranks, process_set_id=-1)
    for ps in basics._state().process_sets.values():
        if ps.ranks == ranks and not ps.removed:
            return ps
    return basics.add_process_set(ranks)


def create_hybrid_mesh(dp: int = 1, pp: int = 1, ep: int = 1, tp: int = 1,
                       sp: int = 1, dcn: int = 1,
                       ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Build this rank's view of a mesh with the requested degrees.

    Axis sizes must multiply to the rank count (`ranks`, default every
    rank of the job).  One axis may be -1 and absorbs the remaining
    ranks, e.g. `create_hybrid_mesh(dp=-1, tp=4)` on 32 ranks gives dp=8,
    tp=4.  Collective: every rank of the job calls it, with the same
    arguments, since it registers each axis' process sets (every rank
    registers every group, in the same order)."""
    ranks = tuple(range(basics.size())) if ranks is None else tuple(ranks)
    sizes = _axis_sizes(len(ranks), {"dcn": dcn, "dp": dp, "pp": pp,
                                     "ep": ep, "tp": tp, "sp": sp})
    shape = [sizes[a] for a in AXIS_ORDER]
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    me = basics.rank()
    pos = ranks.index(me) if me in ranks else None
    coords, sets = {}, {}
    for ax, (axis, size) in enumerate(zip(AXIS_ORDER, shape)):
        mine = None
        # Every group along this axis, in mesh order.
        for base in range(len(ranks)):
            if (base // strides[ax]) % size:
                continue
            group = [ranks[base + j * strides[ax]] for j in range(size)]
            ps = _axis_set(group, size)
            if pos is not None and me in group:
                mine = ps
        if pos is not None:
            coords[axis] = (pos // strides[ax]) % size
            sets[axis] = mine
    return Mesh(shape=dict(zip(AXIS_ORDER, shape)), coords=coords,
                sets=sets, ranks=ranks)


HIER_AXES = ("dcn", "hvd")


def create_hierarchical_mesh(dcn: int, ici: Optional[int] = None,
                             ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Two-tier data-parallel mesh ("dcn", "hvd"): `dcn` slices, `ici`
    ranks a slice (JAX `create_hierarchical_mesh`, parallel/mesh.py:107).
    A row-major reshape of `ranks` (default every rank of the job), so
    rank `d*ici + i` sits at (dcn=d, hvd=i) and the dcn-major linear
    index of a rank is its position in `ranks`.  Each axis gets one
    ProcessSet: "hvd" the ranks of this rank's slice, "dcn" the ranks
    with this rank's in-slice index.  Collective, as
    `create_hybrid_mesh`."""
    ranks = tuple(range(basics.size())) if ranks is None else tuple(ranks)
    n = len(ranks)
    if n % dcn:
        raise HorovodTpuError(f"{n} devices not divisible into {dcn} slices")
    ici = ici or n // dcn
    if dcn * ici != n:
        raise HorovodTpuError(f"dcn={dcn} x ici={ici} != {n} devices")
    me = basics.rank()
    coords, sets = {}, {}
    for d in range(dcn):
        ps = _axis_set([ranks[d * ici + i] for i in range(ici)], ici)
        if me in ranks and ranks.index(me) // ici == d:
            sets["hvd"] = ps
    for i in range(ici):
        ps = _axis_set([ranks[d * ici + i] for d in range(dcn)], dcn)
        if me in ranks and ranks.index(me) % ici == i:
            sets["dcn"] = ps
    if me in ranks:
        pos = ranks.index(me)
        coords = {"dcn": pos // ici, "hvd": pos % ici}
    return Mesh(shape={"dcn": dcn, "hvd": ici}, coords=coords, sets=sets,
                ranks=ranks, axis_names=HIER_AXES)


def is_hierarchical(axis_name) -> bool:
    """Whether `axis_name` is a hierarchical mesh (the port's stand-in
    for JAX's ("dcn", "hvd") axis pair)."""
    return isinstance(axis_name, Mesh) and axis_name.axis_names == HIER_AXES


def mesh_axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape[axis] if axis in mesh.shape else 1


def batch_spec(mesh: Mesh) -> Tuple:
    """The spec of a [batch, ...] input as a tuple of per-dim entries:
    batch over dcn and dp (and ep when experts ride the data axis), the
    JAX module's `P(("dcn", "dp", "ep"))` with the size-1 axes left
    out."""
    axes = [a for a in ("dcn", "dp", "ep") if mesh_axis_size(mesh, a) > 1]
    return (tuple(axes) if axes else None,)
