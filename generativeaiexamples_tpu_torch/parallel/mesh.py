"""Device mesh over rank processes: the port's parallelism substrate.

Counterpart of generativeaiexamples_tpu/parallel/mesh.py. The JAX
package builds a `jax.sharding.Mesh` over every local device and lets
GSPMD place the collectives inside one process. PyTorch's idiom is one
process per rank: here a `Mesh` is the resolved axis sizes, the global
device list (one entry per rank, in rank order, tensor fastest), this
process's rank and device, and the `torch.distributed` process group of
its tensor axis. The axis names, the size resolution (one axis may be
-1) and its error texts, the geometry hint and the logical-axis rules are
the JAX file's.

Backend rule, fixed from the device list before the process group
exists: NCCL when every rank has a CUDA device of its own; gloo when
the ranks are on the CPU or share a device (NCCL refuses two ranks on
one device at init, "Duplicate GPU detected"). gloo's all_reduce,
broadcast and all_gather take CUDA tensors by staging them through host
memory, so two ranks on one card run the same program, only slower.

The tensor-parallel collectives of the model (`tensor_all_reduce`,
`tensor_all_gather`) act on the ACTIVE mesh (`activate`), one a process:
with none active, or a tensor axis of 1, they return their input, so a
single-device forward is unchanged bit for bit. They are the inference
route's and autograd does not see them.

Training (ops/ring_attention.py, parallel/pipeline.py, the sharded train
state of training/trainer.py) takes the collectives below, each a
`torch.autograd.Function` over one mesh axis's process group
(`Mesh.groups`, one per axis of size > 1): `ppermute` (send to the next
rank on the axis, receive from the previous; the backward sends the
gradient the other way round), Megatron's `copy_to_tensor_region`
(identity, all-reduce backward) and `reduce_from_tensor_region`
(all-reduce, identity backward), `gather_from_region` (all-gather, the
backward takes this rank's slice), `scatter_to_region` (this rank's
slice, all-gather backward), `fsdp_gather` (all-gather, reduce-scatter
backward) and `all_reduce_sum` (all-reduce, identity backward). gloo
has no reduce-scatter: there it is an all-reduce and a slice. gloo's
send and receive take CPU tensors only: there `ppermute` stages a CUDA
tensor through a host buffer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import logging
import math
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from generativeaiexamples_tpu_torch.config.schema import MeshConfig

_LOG = logging.getLogger(__name__)

# Canonical axis order: DCN (slowest) first, tensor (fastest) last.
MESH_AXIS_NAMES = ("pipeline", "data", "fsdp", "expert", "sequence", "tensor")

# Seconds the coordinator's store and the process group wait for a peer
# (the JAX runtime's barrier timeout).
STORE_TIMEOUT_S = 600


def _resolve_axis_sizes(cfg: MeshConfig, n_devices: int) -> dict:
    if cfg.ici_data == -1 and cfg.dcn_data == -1:
        raise ValueError("only one of ici_data/dcn_data may be -1")
    data_fixed_factor = 1
    if cfg.ici_data == -1 or cfg.dcn_data == -1:
        # The "data" mesh axis is the ici*dcn product; a wildcard in either
        # factor makes the combined axis the wildcard. The fixed factor must
        # still divide the filled size (checked after resolution below).
        data = -1
        data_fixed_factor = cfg.dcn_data if cfg.ici_data == -1 else cfg.ici_data
    else:
        data = cfg.ici_data * cfg.dcn_data
    sizes = {
        "pipeline": cfg.dcn_pipeline,
        "data": data,
        "fsdp": cfg.ici_fsdp,
        "expert": cfg.ici_expert,
        "sequence": cfg.ici_sequence,
        "tensor": cfg.ici_tensor,
    }
    wildcards = [k for k, v in sizes.items() if v == -1]
    if any(v < 1 and v != -1 for v in sizes.values()):
        raise ValueError(f"mesh axis sizes must be >= 1 or -1, got {sizes}")
    if len(wildcards) > 1:
        raise ValueError(f"at most one mesh axis may be -1, got {wildcards}")
    fixed = math.prod(v for v in sizes.values() if v != -1)
    if wildcards:
        if n_devices % fixed:
            raise ValueError(
                f"{n_devices} devices not divisible by fixed axes product "
                f"{fixed} (requested {sizes}); smallest working geometry: "
                f"{_nearest_geometry(sizes, n_devices)} — fixed axes must "
                f"multiply to a divisor of the device count "
                f"({_divisors(n_devices)})"
            )
        sizes[wildcards[0]] = n_devices // fixed
    elif fixed != n_devices:
        raise ValueError(
            f"mesh axes product {fixed} != device count {n_devices} "
            f"(requested {sizes}); smallest working geometry: "
            f"{_nearest_geometry(sizes, n_devices)} — or set one axis "
            f"to -1 to auto-fill"
        )
    if sizes["data"] % data_fixed_factor:
        raise ValueError(
            f"resolved data axis {sizes['data']} not divisible by the fixed "
            f"data factor {data_fixed_factor} (ici_data={cfg.ici_data}, "
            f"dcn_data={cfg.dcn_data}); pick ici_data*dcn_data from the "
            f"device-count divisors {_divisors(n_devices)}"
        )
    return sizes


def _divisors(n: int, cap: int = 12) -> list:
    ds = [d for d in range(1, n + 1) if n % d == 0]
    return ds if len(ds) <= cap else ds[:cap] + ["..."]


def _nearest_geometry(sizes: dict, n_devices: int) -> dict:
    """Smallest-perturbation working geometry for an error hint: keep
    every requested axis clamped to its largest divisor-of-remaining
    value (walking slowest axis first), park leftover devices on
    tensor. Always multiplies to exactly n_devices."""
    out = {}
    rem = n_devices
    for name in MESH_AXIS_NAMES:
        want = sizes.get(name, 1)
        want = 1 if want == -1 else max(1, want)
        got = max(d for d in range(1, min(want, rem) + 1) if rem % d == 0)
        out[name] = got
        rem //= got
    out["tensor"] *= rem  # leftover rides the TP axis (serving default)
    return {k: v for k, v in out.items() if v != 1} or {"tensor": 1}


def backend_for(devices: Sequence) -> str:
    """The process-group backend of a mesh over `devices` (one a rank):
    "nccl" when every rank has a CUDA device of its own, else "gloo"."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len(
            {d.index for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


@dataclasses.dataclass
class Mesh:
    """The resolved mesh as one rank process sees it. `devices` holds one
    device per rank in rank order (row-major over MESH_AXIS_NAMES, tensor
    fastest); `group` is the process group of this rank's tensor axis
    (None when the mesh has one rank)."""

    shape: Dict[str, int]
    devices: List[torch.device]
    rank: int = 0
    group: Any = None
    backend: str = ""
    # The process group of this rank's line along each axis of size > 1
    # (training's collectives; `group` is groups["tensor"]).
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def tensor(self) -> int:
        return int(self.shape.get("tensor", 1))

    @property
    def tensor_rank(self) -> int:
        """This rank's coordinate on the tensor axis."""
        return self.rank % self.tensor

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    @property
    def shared_device(self) -> bool:
        """More than one rank on one device (gloo's case)."""
        return len(set(self.devices)) < len(self.devices)

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on every axis."""
        return _coords(self.shape, self.rank)

    def axis_ranks(self, axis: str) -> List[int]:
        """The global ranks along `axis` through this rank, in axis
        order."""
        return _line(self.shape, self.rank, axis)


def _coords(shape: Dict[str, int], rank: int) -> Dict[str, int]:
    out, r = {}, rank
    for name in reversed(MESH_AXIS_NAMES):
        n = shape[name]
        out[name] = r % n
        r //= n
    return {name: out[name] for name in MESH_AXIS_NAMES}


def _line(shape: Dict[str, int], rank: int, axis: str) -> List[int]:
    """The ranks that share every coordinate of `rank` but `axis`'s."""
    stride = 1
    for name in reversed(MESH_AXIS_NAMES):
        if name == axis:
            break
        stride *= shape[name]
    base = rank - _coords(shape, rank)[axis] * stride
    return [base + i * stride for i in range(shape[axis])]


def _rank_devices(devices: Sequence) -> List[torch.device]:
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", 0)
        out.append(d)
    return out


def build_mesh(cfg: Optional[MeshConfig] = None,
               devices: Optional[Sequence] = None,
               rank: Optional[int] = None) -> Mesh:
    """The mesh of `cfg` over `devices` (one entry per rank; a device may
    repeat, e.g. two ranks on "cuda:0"; default: this host's CUDA devices,
    else one CPU) as rank `rank` sees it (default: this process's rank in
    the initialized process group, else 0). When the process group exists
    it must span the mesh, and the tensor axis's group is made here
    (every rank calls this in the same order); without one the mesh is a
    plan of the geometry (no collectives: an engine over it refuses to
    replay, `multihost.validate_multihost_profile`)."""
    cfg = cfg or MeshConfig()
    devs = _rank_devices(devices if devices is not None
                         else local_devices())
    sizes = _resolve_axis_sizes(cfg, len(devs))
    shape = {a: sizes[a] for a in MESH_AXIS_NAMES}
    dist = torch.distributed
    live = dist.is_available() and dist.is_initialized()
    if rank is None:
        rank = dist.get_rank() if live else 0
    mesh = Mesh(shape, devs, rank=int(rank), backend=backend_for(devs))
    if len(devs) > 1 and live:
        if dist.get_world_size() != len(devs):
            raise RuntimeError(
                f"the process group spans {dist.get_world_size()} ranks but "
                f"the mesh lists {len(devs)} devices")
        mesh.groups = _axis_groups(shape)
        mesh.group = mesh.groups.get("tensor")
    return mesh


def _axis_groups(shape: Dict[str, int]) -> Dict[str, Any]:
    """The process group of this rank's line along every axis of size >
    1: the world when the axis spans it, else one new group per line
    (made by every rank in the same order, axis by axis, as
    torch.distributed requires)."""
    dist = torch.distributed
    n = math.prod(shape.values())
    me = dist.get_rank()
    out: Dict[str, Any] = {}
    for axis in MESH_AXIS_NAMES:
        size = shape[axis]
        if size == 1:
            continue
        if size == n:
            out[axis] = dist.group.WORLD
            continue
        seen = set()
        for r in range(n):
            ranks = _line(shape, r, axis)
            if ranks[0] in seen:
                continue
            seen.add(ranks[0])
            g = dist.new_group(ranks)
            if me in ranks:
                out[axis] = g
    return out


def axis_devices(mesh: Mesh, axis: str = "tensor") -> List[torch.device]:
    """The devices along `axis` of `mesh`, in axis order, with every
    other axis at this rank's coordinate: where one process places the
    shards of an array sharded on `axis` (the sharded indexes of
    ops/topk.py and ops/ivf.py, which run in one process as JAX's do).
    Each is resolved (`device.resolve_device`), so a CUDA device on a
    host without one raises."""
    from generativeaiexamples_tpu_torch.device import resolve_device

    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r}; axes: "
                         f"{list(mesh.shape)}")
    return [resolve_device(mesh.devices[r]) for r in mesh.axis_ranks(axis)]


def single_device_mesh(device=None) -> Mesh:
    """Trivial 1-device mesh (all axes size 1)."""
    device = torch.device(device) if device is not None else \
        _rank_devices(local_devices())[0]
    return Mesh({a: 1 for a in MESH_AXIS_NAMES}, [device])


def mesh_axis_size(mesh: Optional[Mesh], name: str) -> int:
    return int(mesh.shape.get(name, 1)) if mesh is not None else 1


def local_devices() -> List[torch.device]:
    """This host's devices: every visible CUDA device, else the CPU."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


# ---------------------------------------------------------------------------
# Logical sharding rules
# ---------------------------------------------------------------------------
# The JAX package's rule table: model code names logical axes, the table
# maps them to mesh axes (Megatron layout: heads, kv heads, the MLP's
# intermediate and the vocabulary on "tensor").

LLM_RULES: dict = {
    "batch": ("data", "fsdp"),
    "seq": "sequence",
    "embed": None,
    "embed_fsdp": "fsdp",  # weight hidden-dim axis: FSDP shards here
    "heads": "tensor",
    "kv_heads": "tensor",
    "head_dim": None,
    "mlp": "tensor",
    "vocab": "tensor",
    "expert": "expert",
    "layers": None,  # stacked-layer leading axis — never sharded
    "kv_pages": None,
}


def logical_to_spec(logical_axes: Sequence[Optional[str]],
                    rules: dict = LLM_RULES) -> tuple:
    """("batch","seq","embed") -> (("data","fsdp"), "sequence", None): the
    JAX PartitionSpec's entries as a tuple."""
    out = []
    for ax in logical_axes:
        if ax is None:
            out.append(None)
        else:
            if ax not in rules:
                raise KeyError(f"unknown logical axis {ax!r}")
            out.append(rules[ax])
    return tuple(out)


# ---------------------------------------------------------------------------
# Rank processes
# ---------------------------------------------------------------------------

_STORE = None  # the coordinator's TCPStore once the group exists


def is_multihost() -> bool:
    """More than one rank process in the initialized process group."""
    dist = torch.distributed
    return bool(dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1)


def coordination_store():
    """The coordinator's key-value store (the dispatch log's transport),
    or None before `init_ranks` / `maybe_initialize_distributed`."""
    return _STORE


def devices_colocated(a, b) -> bool:
    """Are every device in `a` and `b` addressable from THIS process (so a
    tensor copy moves between them without serialization)? Empty sets
    are NOT colocated: an engine with no live tensors has no path."""
    a = {torch.device(d) for d in a}
    b = {torch.device(d) for d in b}
    if not a or not b:
        return False
    n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0

    def local(d: torch.device) -> bool:
        return d.type == "cpu" or (d.type == "cuda"
                                   and (d.index or 0) < n_cuda)

    return all(local(d) for d in a | b)


def init_ranks(coordinator: str, world_size: int, rank: int,
               devices: Sequence) -> None:
    """Create the process group of `world_size` rank processes: a TCPStore
    at `coordinator` ("host:port", served by rank 0) and
    `init_process_group` over it, with the backend of `backend_for(devices)`
    (`devices`: one per rank, as `build_mesh` takes them). A CUDA rank
    binds its device first. Failures propagate: an uncoordinated rank
    would compute wrong collectives."""
    global _STORE
    dist = torch.distributed
    devs = _rank_devices(devices)
    if len(devs) != world_size:
        raise ValueError(f"{len(devs)} devices listed for {world_size} "
                         f"rank processes")
    host, _, port = coordinator.rpartition(":")
    if not host or not port:
        raise ValueError(f"coordinator {coordinator!r} is not host:port")
    timeout = datetime.timedelta(seconds=STORE_TIMEOUT_S)
    store = dist.TCPStore(host, int(port), world_size, rank == 0,
                          timeout=timeout)
    backend = backend_for(devs)
    kw: Dict[str, Any] = {}
    if devs[rank].type == "cuda":
        torch.cuda.set_device(devs[rank])
        if backend == "nccl":
            kw["device_id"] = devs[rank]
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, timeout=timeout, **kw)
    _STORE = store
    _LOG.info("rank %d/%d: process group up (%s) on %s", rank, world_size,
              backend, devs[rank])


def maybe_initialize_distributed(cfg: Optional[MeshConfig] = None,
                                 devices: Optional[Sequence] = None
                                 ) -> bool:
    """Multi-process init: a no-op unless a coordinator is named, by the
    JAX_COORDINATOR_ADDRESS env (which wins, as launchers template
    per-host env) or by `cfg.coordinator_address` / `cfg.num_processes`
    / `cfg.process_id` (the --coordinator / --num-processes /
    --process-id serve flags); the env names and fields are the JAX
    package's. `devices` lists one device per rank (default: one rank
    a local device) and fixes the backend. Returns True when this call
    made the process group. Failures propagate."""
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS", "")
    n_str = os.environ.get("JAX_NUM_PROCESSES", "")
    p_str = os.environ.get("JAX_PROCESS_ID", "")
    n_proc = int(n_str) if n_str else 0
    proc_id = int(p_str) if p_str else -1
    if cfg is not None:
        coord = coord or cfg.coordinator_address
        n_proc = n_proc or cfg.num_processes
        proc_id = proc_id if proc_id >= 0 else cfg.process_id
    if not coord:
        return False
    dist = torch.distributed
    if dist.is_initialized():
        return False
    if n_proc <= 0 or proc_id < 0:
        raise ValueError(
            f"coordinator {coord!r} named without the process count and "
            f"this process's id (num_processes={n_proc}, "
            f"process_id={proc_id}); torch.distributed cannot infer them")
    devs = list(devices) if devices is not None else local_devices()
    if len(devs) != n_proc:
        raise ValueError(f"{len(devs)} devices listed for {n_proc} rank "
                         f"processes (one device a rank)")
    init_ranks(coord, n_proc, proc_id, devs)
    return True


def shutdown() -> None:
    """Tear the process group down (a rank's last act)."""
    global _STORE
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _STORE = None


# ---------------------------------------------------------------------------
# The model's tensor-parallel collectives
# ---------------------------------------------------------------------------

_ACTIVE: Optional[Mesh] = None
_ACTIVE_SEQ: Optional[Mesh] = None

# Counters of the collectives (this process): calls and bytes always;
# seconds only while COLLECTIVE_TIMING is set (a measurement's switch),
# which synchronizes the device around each call so the time is the
# collective's alone.
COLLECTIVE_STATS = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0,
                    "ppermute": 0, "bytes": 0, "seconds": 0.0}
COLLECTIVE_TIMING = False


def activate(mesh: Optional[Mesh]) -> None:
    """Make `mesh` this process's tensor-parallel mesh (None or a tensor
    axis of 1: no collectives), and, when its "sequence" axis is above 1,
    the mesh the training route's ring attention runs over
    (`active_sequence_mesh`)."""
    global _ACTIVE, _ACTIVE_SEQ
    _ACTIVE = mesh if mesh is not None and mesh.tensor > 1 else None
    _ACTIVE_SEQ = mesh if mesh_axis_size(mesh, "sequence") > 1 else None


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE


def active_sequence_mesh() -> Optional[Mesh]:
    """The active mesh when its "sequence" axis is above 1, else None."""
    return _ACTIVE_SEQ


@contextlib.contextmanager
def active(mesh: Optional[Mesh]):
    """`activate(mesh)` for the block, then the meshes that were active
    before. A training step holds it over its forward AND backward: a
    layer recomputed under remat re-issues its collectives."""
    global _ACTIVE, _ACTIVE_SEQ
    prev = (_ACTIVE, _ACTIVE_SEQ)
    activate(mesh)
    try:
        yield
    finally:
        _ACTIVE, _ACTIVE_SEQ = prev


def tensor_shard() -> tuple:
    """(this rank's tensor coordinate, tensor axis size) of the active
    mesh; (0, 1) without one."""
    m = _ACTIVE
    return (0, 1) if m is None else (m.tensor_rank, m.tensor)


def _timed(fn, x: torch.Tensor, kind: str, nbytes: int):
    COLLECTIVE_STATS[kind] += 1
    COLLECTIVE_STATS["bytes"] += nbytes
    if not COLLECTIVE_TIMING:
        return fn()
    cuda = x.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize(x.device)
    COLLECTIVE_STATS["seconds"] += time.perf_counter() - t0
    return out


def tensor_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum `x` over the active tensor axis (every rank gets the same
    bits); `x` itself with no active mesh."""
    m = _ACTIVE
    if m is None:
        return x
    x = x.contiguous()

    def run():
        torch.distributed.all_reduce(x, group=m.group)
        return x

    return _timed(run, x, "all_reduce", x.numel() * x.element_size())


def tensor_all_gather(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Concatenate every rank's `x` along `dim` in tensor-rank order;
    `x` itself with no active mesh."""
    m = _ACTIVE
    if m is None:
        return x
    x = x.contiguous()

    def run():
        parts = [torch.empty_like(x) for _ in range(m.tensor)]
        torch.distributed.all_gather(parts, x, group=m.group)
        return torch.cat(parts, dim=dim)

    return _timed(run, x, "all_gather",
                  m.tensor * x.numel() * x.element_size())


def reset_collective_stats() -> None:
    for k in COLLECTIVE_STATS:
        COLLECTIVE_STATS[k] = 0.0 if k == "seconds" else 0



# ---------------------------------------------------------------------------
# Training's collectives: one mesh axis each, seen by autograd
# ---------------------------------------------------------------------------


def _group(mesh: Mesh, axis: str):
    g = mesh.groups.get(axis)
    if g is None:
        raise RuntimeError(
            f"mesh axis {axis!r} of size {mesh.shape[axis]} has no process "
            f"group: build the mesh after the rank processes' group "
            f"exists (init_ranks)")
    return g


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def all_reduce_raw(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum of `x` over `axis` as a new tensor (`x` is left as it was)."""
    if mesh_axis_size(mesh, axis) == 1:
        return x
    out = x.detach().clone(memory_format=torch.contiguous_format)

    def run():
        torch.distributed.all_reduce(out, group=_group(mesh, axis))
        return out

    return _timed(run, out, "all_reduce", _nbytes(out))


def all_gather_raw(x: torch.Tensor, mesh: Mesh, axis: str,
                   dim: int) -> torch.Tensor:
    """Every rank's `x` on `axis`, concatenated along `dim` in axis
    order."""
    n = mesh_axis_size(mesh, axis)
    if n == 1:
        return x
    x = x.detach().contiguous()

    def run():
        parts = [torch.empty_like(x) for _ in range(n)]
        torch.distributed.all_gather(parts, x, group=_group(mesh, axis))
        return torch.cat(parts, dim=dim)

    return _timed(run, x, "all_gather", n * _nbytes(x))


def axis_slice(x: torch.Tensor, mesh: Mesh, axis: str,
               dim: int) -> torch.Tensor:
    """This rank's block of `x` along `dim` when `dim` splits over
    `axis`, as a tensor of its own."""
    n = mesh_axis_size(mesh, axis)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dimension {x.shape[dim]} does not split over "
                         f"the {n}-way {axis} axis")
    step = x.shape[dim] // n
    return x.narrow(dim, mesh.coords[axis] * step, step).contiguous()


def reduce_scatter_raw(x: torch.Tensor, mesh: Mesh, axis: str,
                       dim: int) -> torch.Tensor:
    """This rank's block along `dim` of the sum of `x` over `axis`. gloo
    has no reduce-scatter: there it is an all-reduce and a slice."""
    n = mesh_axis_size(mesh, axis)
    if n == 1:
        return x
    x = x.detach()
    if mesh.backend == "nccl":
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))

        def run():
            torch.distributed.reduce_scatter_tensor(
                out, src, group=_group(mesh, axis))
            return out.movedim(0, dim).contiguous()

        return _timed(run, src, "reduce_scatter", _nbytes(src))
    full = x.clone(memory_format=torch.contiguous_format)

    def run():
        torch.distributed.all_reduce(full, group=_group(mesh, axis))
        return axis_slice(full, mesh, axis, dim)

    return _timed(run, full, "reduce_scatter", _nbytes(full))


def ppermute_raw(x: torch.Tensor, mesh: Mesh, axis: str,
                 shift: int = 1) -> torch.Tensor:
    """Send `x` to the rank `shift` steps on along `axis` (cyclically)
    and return what the rank `shift` steps back sent. On gloo, whose
    send and receive take CPU tensors only, a CUDA tensor goes through a
    host buffer."""
    n = mesh_axis_size(mesh, axis)
    if n == 1 or shift % n == 0:
        return x
    ranks = mesh.axis_ranks(axis)
    me = mesh.coords[axis]
    dst, src = ranks[(me + shift) % n], ranks[(me - shift) % n]
    group = _group(mesh, axis)
    stage = mesh.backend != "nccl" and x.device.type != "cpu"
    send = x.detach().contiguous()
    if stage:
        send = send.cpu()
    recv = torch.empty_like(send)

    def run():
        works = [torch.distributed.isend(send, dst, group=group),
                 torch.distributed.irecv(recv, src, group=group)]
        for w in works:
            w.wait()
        return recv.to(x.device) if stage else recv

    return _timed(run, x, "ppermute", _nbytes(send))


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return ppermute_raw(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return ppermute_raw(g, ctx.mesh, ctx.axis, -ctx.shift), None, None, \
            None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_raw(g, ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce_raw(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather_raw(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return axis_slice(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return axis_slice(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_raw(g, ctx.mesh, ctx.axis, ctx.dim), None, None, \
            None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather_raw(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_raw(g, ctx.mesh, ctx.axis, ctx.dim), None, \
            None, None


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str,
             shift: int = 1) -> torch.Tensor:
    """`ppermute_raw` seen by autograd: the backward sends the gradient
    `shift` steps back (JAX's `lax.ppermute` transpose)."""
    if mesh_axis_size(mesh, axis) == 1:
        return x
    return _Ppermute.apply(x, mesh, axis, shift)


def copy_to_tensor_region(x: torch.Tensor, mesh: Mesh,
                          axis: str = "tensor") -> torch.Tensor:
    """Megatron's f: the identity, whose backward sums the gradient over
    `axis` (the input of a column-parallel matmul)."""
    if mesh_axis_size(mesh, axis) == 1:
        return x
    return _CopyTo.apply(x, mesh, axis)


def reduce_from_tensor_region(x: torch.Tensor, mesh: Mesh,
                              axis: str = "tensor") -> torch.Tensor:
    """Megatron's g: the sum over `axis`, whose backward is the identity
    (the output of a row-parallel matmul)."""
    if mesh_axis_size(mesh, axis) == 1:
        return x
    return _ReduceFrom.apply(x, mesh, axis)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """The sum of `x` over each axis of `axes` (a name or a sequence),
    with the identity backward: every rank differentiates the same
    global sum through its own part."""
    for axis in (axes,) if isinstance(axes, str) else tuple(axes):
        x = reduce_from_tensor_region(x, mesh, axis)
    return x


def gather_from_region(x: torch.Tensor, mesh: Mesh, axis: str,
                       dim: int) -> torch.Tensor:
    """All-gather along `dim` over `axis`; the backward takes this rank's
    slice (what follows is replicated over `axis`)."""
    if mesh_axis_size(mesh, axis) == 1:
        return x
    return _GatherFrom.apply(x, mesh, axis, dim)


def scatter_to_region(x: torch.Tensor, mesh: Mesh, axis: str,
                      dim: int) -> torch.Tensor:
    """This rank's slice along `dim` of a tensor replicated over `axis`;
    the backward all-gathers the slices' gradients."""
    if mesh_axis_size(mesh, axis) == 1:
        return x
    return _ScatterTo.apply(x, mesh, axis, dim)


def fsdp_gather(x: torch.Tensor, mesh: Mesh, dim: int,
                axis: str = "fsdp") -> torch.Tensor:
    """A shard gathered whole along `dim` over `axis`; the backward
    reduce-scatters (sums) the gradient back to this rank's shard."""
    if mesh_axis_size(mesh, axis) == 1:
        return x
    return _FsdpGather.apply(x, mesh, axis, dim)
